from .mesh import make_mesh  # noqa: F401
from .sharded import make_sharded_stepper  # noqa: F401
