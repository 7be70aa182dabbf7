"""reazonspeech_tpu_torch — the PyTorch/CUDA port of reazonspeech_tpu.

The JAX package beside it is the reference. This package imports ``torch``
and never ``jax``; it mirrors the reference's layout so every module has a
counterpart of the same name, and it reads the same native param trees
(``convert/store.py``).

Ported so far: everything but ``parallel/`` —

    frontend/features.py        log-mel (nemo and kaldi presets)
    frontend/resample.py        polyphase resampling on the input's device
    models/fastconformer.py     FastConformer encoder (nemo-v2)
    models/fastconformer_streaming.py  cache-based streaming encoder
    models/zipformer.py         Zipformer2 encoder (k2)
    models/rnnt.py              LSTM and stateless predictors + joint
    models/conformer.py         Conformer encoder (espnet)
    decoding/rnnt_beam.py       ALSD beam search (LSTM or stateless predictor)
    decoding/transducer_graves.py  Graves beam search (espnet)
    decoding/rnnt_greedy.py     label-looping greedy decode
    decoding/ctc.py             CTC blank scan and Viterbi alignment (espnet)
    nemo/asr/, k2/asr/, espnet/asr/  load_model / transcribe / transcribe_batch / cli
    avsr/                       AV-HuBERT (ResNet3D + transformer encoder, cached
                                greedy / beam generate), plain PyTorch in fp32
    serving/                    the micro-batchers, the continuous executor, HTTP
    convert/                    the checkpoint converters (.nemo, espnet zoo,
                                icefall + sherpa-onnx, HF AV-HuBERT), the int8
                                writer, the store
    training/                   RNN-T/pruned/CTC losses, the train step, the Trainer
    evaluation/                 the CER harness over HF datasets (copies)
    native/                     the host-side C++ library (g++ at first use)
    utils/                      RTFxMeter, torch.profiler traces, the build cache
    core/                       copies of the JAX package's jax-free core

with hand-written Hopper kernels under ``csrc/`` (rel-pos attention, the
Conformer conv module, the LayerNorm-fused projections and residual tail,
the beam search's log-softmax + top-m, the Zipformer shared attention, and
the beam decoders' opt-in fused joint + top-m and LSTM cell step),
each beside a plain PyTorch twin in ``ops/``. Entry points run on the GPU
unless given ``device="cpu"``.
"""

__version__ = "0.1.0"
