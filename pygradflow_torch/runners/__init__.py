from .instance import Instance  # noqa: F401
from .runner import Runner  # noqa: F401
