"""reazonspeech_tpu_torch — the PyTorch/CUDA port of reazonspeech_tpu.

The JAX package beside it is the reference. This package imports ``torch``
and never ``jax``; it mirrors the reference's layout so every module has a
counterpart of the same name, and it reads the same native param trees
(``convert/store.py``).

Ported so far: the nemo-v2, k2 and espnet serving paths —

    frontend/features.py        log-mel (nemo and kaldi presets)
    models/fastconformer.py     FastConformer encoder (nemo-v2)
    models/zipformer.py         Zipformer2 encoder (k2)
    models/rnnt.py              LSTM and stateless predictors + joint
    models/conformer.py         Conformer encoder (espnet)
    decoding/rnnt_beam.py       ALSD beam search (LSTM or stateless predictor)
    decoding/transducer_graves.py  Graves beam search (espnet)
    decoding/rnnt_greedy.py     label-looping greedy decode
    decoding/ctc.py             CTC blank scan and Viterbi alignment (espnet)
    nemo/asr/, k2/asr/, espnet/asr/  load_model / transcribe / transcribe_batch / cli
    core/                       copies of the JAX package's jax-free core

with hand-written Hopper kernels under ``csrc/`` (rel-pos attention, the
Conformer conv module, the LayerNorm-fused projections and residual tail,
the beam search's log-softmax + top-m, the Zipformer shared attention, and
the beam decoders' opt-in fused joint + top-m and LSTM cell step),
each beside a plain PyTorch twin in ``ops/``. Entry points run on the GPU
unless given ``device="cpu"``.
"""

__version__ = "0.1.0"
