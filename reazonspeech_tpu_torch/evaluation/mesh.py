"""Single-process mesh evaluation: one evaluator spans several devices.

Port of ``reazonspeech_tpu/evaluation/mesh.py``. The reference's only
multi-accelerator story is process-level data parallelism (N workers, one GPU
each, ``BaseEvaluator(num_proc=..., num_gpus=...)``, which the port keeps).
:func:`mesh_model` is the other shape: ONE process holds the devices as a
mesh and the evaluation batch is split over its data axis, so the weights load
once per device and the host pipeline (audio decode, CER scoring) stays
in-process. It wraps a flavor container in
:class:`~reazonspeech_tpu_torch.parallel.serving.DataParallelDecoder`, which
keeps the container contract (``decode_batch``/``decode_single`` and attribute
delegation), so each flavor's ``transcribe``/``transcribe_batch`` runs over the
mesh unchanged.
"""

from __future__ import annotations

__all__ = ["mesh_model"]


def mesh_model(model, n_data: int, devices=None):
    """Wrap a flavor container so its decode spans ``n_data`` devices.

    Args:
      model: a nemo/espnet/k2 container exposing ``decode_batch_fn()``
      n_data: the mesh's data-axis size (entries the batch splits over)
      devices: the entries (``torch.device``s, repeats allowed); default the
        first ``n_data`` visible CUDA devices, raising where there are fewer

    Returns a drop-in replacement for ``model`` whose ``decode_batch`` /
    ``decode_single`` run data-parallel over the mesh; every other
    attribute (tokenizer, configs) is the wrapped container's.
    """
    from ..parallel.mesh import cuda_devices, make_mesh
    from ..parallel.serving import DataParallelDecoder

    if devices is None:
        devices = cuda_devices()[:n_data]
    if len(devices) < n_data:
        raise ValueError(
            f"mesh evaluation needs {n_data} devices, have {len(devices)}; pass devices= "
            "explicitly (entries may repeat a device, e.g. [torch.device('cpu')] * n_data)")
    return DataParallelDecoder(model, make_mesh(n_data=n_data, devices=list(devices)[:n_data]))
