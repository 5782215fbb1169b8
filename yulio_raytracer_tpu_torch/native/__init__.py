"""The C ABI shim (yuliort_shim.cpp) and its build (build.py)."""
