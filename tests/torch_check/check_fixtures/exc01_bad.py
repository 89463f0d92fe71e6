"""EXC01 fixture: broad handlers that swallow silently."""


def load(path):
    try:
        return open(path).read()
    except Exception:
        return None


def probe(fn):
    try:
        fn()
    except:  # noqa: E722
        pass
