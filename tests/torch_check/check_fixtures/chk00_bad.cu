// CHK00 fixture (CUDA): malformed suppression directives (empty rule
// list, and a missing mandatory reason), and a well-formed one.

int x = 1;  // check: disable=

// check: disable=DET01
int y = 2;

// check: disable=KRN01 -- well formed: silences nothing here
int z = 3;
