"""Version module (reference src/python/_version.py).

Copy of kvxopt_tpu/_version.py: the port carries the JAX package's
version."""

__version__ = version = "0.1.0"
