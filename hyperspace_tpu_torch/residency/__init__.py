"""Device-memory accounting shared by the residency caches and the build."""
