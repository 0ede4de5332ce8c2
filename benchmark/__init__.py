"""The benchmark of kvxopt_tpu_torch on the H100 (see README.md)."""
