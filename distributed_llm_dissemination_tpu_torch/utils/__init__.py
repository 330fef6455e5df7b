from .logging import JsonLogger, configure, log  # noqa: F401
from .rate import DEFAULT_BURST, PacedWriter, TokenBucket  # noqa: F401
