from .context import MpcContext, ShareArray  # noqa: F401
from .preprocessing import PreProcessedElements  # noqa: F401
