from .stepper import make_stepper  # noqa: F401
