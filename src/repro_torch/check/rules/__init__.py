"""Importing this package registers every rule with the registry."""

from . import (  # noqa: F401
    chk00,
    det01,
    det02,
    exc01,
    ft01,
    krn01,
    kv01,
    sched01,
    spmd01,
)
