"""Package metadata (reference src/python/info.py).

Copy of kvxopt_tpu/info.py."""

version = "0.1.0"
license = "GPL-3.0-or-later"
copyright = "kvxopt_tpu contributors"
