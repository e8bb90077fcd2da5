from .logging import logger, log_dist
from .timer import SynchronizedWallClockTimer
from .monitor import ServingMetrics
