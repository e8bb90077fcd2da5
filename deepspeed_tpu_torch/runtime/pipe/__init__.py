from .module import PipelineModule, LayerSpec, TiedLayerSpec, Layer
from .engine import PipelineEngine, PipelineError
from .topology_compat import *  # noqa: F401,F403
