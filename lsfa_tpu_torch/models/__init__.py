"""LSFA network modules (NCHW inside, NHWC at the LSFA methods)."""
