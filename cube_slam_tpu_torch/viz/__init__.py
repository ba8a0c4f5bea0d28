from . import drawing  # noqa: F401
