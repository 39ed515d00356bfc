from . import shard  # noqa: F401
