"""CHK00 clean fixture: a well-formed suppression (rule list + reason)
silences the finding it covers and raises no hygiene finding itself."""


def probe(fn):
    try:
        fn()
    # check: disable=EXC01 -- capability probe: any failure means absent
    except Exception:
        return None
