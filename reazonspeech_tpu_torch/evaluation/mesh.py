"""Single-process mesh evaluation (not ported yet).

``reazonspeech_tpu/evaluation/mesh.py`` wraps a flavor container in
``parallel.serving.DataParallelDecoder`` so that one evaluator spans several
devices. The port's ``parallel/`` is ROADMAP.md's queue 1 item 10;
until it lands :func:`mesh_model` keeps the JAX signature and raises, as
``ContinuousBatcher(mesh=...)`` and ``reazonspeech-serve --mesh-data`` do.
Process-level data parallelism (``BaseEvaluator(num_proc=..., num_gpus=...)``)
works without it.
"""

from __future__ import annotations

__all__ = ["mesh_model"]


def mesh_model(model, n_data: int, devices=None):
    """Wrap a flavor container so its decode spans ``n_data`` devices.

    Not ported yet: raises NotImplementedError naming ROADMAP.md's queue 1
    item 10 (``parallel/*`` on ``torch.distributed``).
    """
    raise NotImplementedError(
        f"mesh_model(n_data={n_data}) is not ported yet: data-parallel decoding over "
        "several cards needs parallel/* (ROADMAP.md, queue 1 item 10)")
