"""The explain API: a query's plan with and without Hyperspace, the
indexes used, and (verbose) an operator-count diff and engine metrics."""
