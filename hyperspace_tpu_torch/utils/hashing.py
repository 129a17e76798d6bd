"""Stable hashing for signatures and fingerprints.

Parity: com/microsoft/hyperspace/util/HashingUtils.scala:24-34 (md5Hex over
a string). md5 is kept so fingerprints are deterministic and cheap; the
*contract* is stability across processes, not cryptographic strength.
"""

from __future__ import annotations

import hashlib
from typing import Any


def md5_hex(value: Any) -> str:
    """Stable md5 hex digest of ``str(value)`` encoded as UTF-8.

    Reference: HashingUtils.scala:24-34 routes everything through
    ``DigestUtils.md5Hex``; the same any-to-string fold is used here.
    """
    return hashlib.md5(str(value).encode("utf-8")).hexdigest()
