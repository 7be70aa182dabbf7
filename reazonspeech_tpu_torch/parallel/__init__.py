"""Parallelism over a single-process mesh of devices (PyTorch).

Port of ``reazonspeech_tpu.parallel``: data-parallel decode and serving
(``serving``), the GPipe encoder (``pipeline``), sequence-parallel encode
(``sequence``) and data x tensor parallel training (``mesh`` rules,
``tensor``). One process drives every entry of a :class:`mesh.Mesh`, whose
entries are ``torch.device``s and may repeat one.
"""

from .mesh import Mesh, make_mesh, shard_batch, shard_params
from .pipeline import PipelineSpec, make_pipeline_mesh, pipeline_parallel_encode
from .sequence import sequence_parallel_config, sequence_parallel_encode
from .serving import DataParallelDecoder

__all__ = [
    "DataParallelDecoder",
    "Mesh",
    "make_mesh",
    "make_pipeline_mesh",
    "PipelineSpec",
    "pipeline_parallel_encode",
    "shard_params",
    "shard_batch",
    "sequence_parallel_config",
    "sequence_parallel_encode",
]
