"""Public pipeline API (reference: deepspeed/pipe/__init__.py)."""
from ..runtime.pipe import (PipelineModule, LayerSpec, TiedLayerSpec, Layer,
                            PipelineEngine, PipelineError)
