"""reazonspeech_tpu_torch — the PyTorch/CUDA port of reazonspeech_tpu.

The JAX package beside it is the reference. This package imports ``torch``
and never ``jax``; it mirrors the reference's layout so every module has a
counterpart of the same name, and it reads the same native param trees
(``convert/store.py``).

Ported so far: the nemo-v2 serving path —

    frontend/features.py        log-mel (nemo preset)
    models/fastconformer.py     FastConformer encoder
    models/rnnt.py              LSTM predictor + joint
    decoding/rnnt_beam.py       ALSD beam search
    decoding/rnnt_greedy.py     label-looping greedy decode
    nemo/asr/                   load_model / transcribe / transcribe_batch / cli

with three hand-written Hopper kernels under ``csrc/`` (rel-pos attention,
the Conformer conv module, and the beam search's log-softmax + top-m),
each beside a plain PyTorch twin in ``ops/``.
"""

__version__ = "0.1.0"
