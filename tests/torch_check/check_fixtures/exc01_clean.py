"""EXC01 clean fixture: narrow types, or log-and-reraise."""

import logging

log = logging.getLogger(__name__)


def load(path):
    try:
        return open(path).read()
    except OSError:
        return None


def probe(fn):
    try:
        fn()
    except Exception:
        log.warning("probe failed")
        raise
