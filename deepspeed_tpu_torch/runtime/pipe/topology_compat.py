"""Re-export topology types under the reference's import path
(deepspeed.runtime.pipe.topology)."""
from ...parallel.topology import (ProcessTopology, PipeDataParallelTopology,
                                  PipeModelDataParallelTopology, MeshGrid,
                                  _prime_factors)

PipelineParallelGrid = MeshGrid
