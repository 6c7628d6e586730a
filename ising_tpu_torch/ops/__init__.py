from .registry import available_backends, get_backend  # noqa: F401
