"""CHK00 fixture: malformed suppression directives (empty rule list, and
a missing mandatory reason)."""

X = 1  # check: disable=

# check: disable=DET01
Y = 2
