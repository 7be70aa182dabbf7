"""k2-flavor model container: Zipformer + stateless transducer (PyTorch).

Port of ``reazonspeech_tpu.k2.asr.model``: kaldi-convention fbank →
Zipformer2 encoder → label-looping greedy decode (or, with
``decoding="beam"``, ALSD beam search) with the k2 stateless (2-token
context) prediction network, blank-first token convention. The
waveform is the only host→device copy and the emission buffers the only
device→host copy of a batch.

On a CUDA device, ``load_model_container`` serves the reference's TPU
serving configuration: the shared-attention kernels (``attn_impl="pallas"``),
bf16 compute with fp32 accumulation, an fp32 residual stream, and no TF32.
On the CPU it runs the plain formulas.
"""

import os
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ...convert.from_jax import params_from_numpy
from ...convert.quantize import dequantize_tree, is_quantized
from ...convert.store import load_param_tree
from ...core.hub import CheckpointNotFoundError
from ...core.tokenizer import VocabTokenizer
from ...decoding.rnnt_beam import BeamDecodeConfig, rnnt_beam_decode
from ...decoding.rnnt_greedy import GreedyDecodeConfig, rnnt_greedy_decode
from ...device import resolve_device, set_fp32_matmul_policy
from ...frontend.features import FrontendConfig, kaldi_frontend_config, log_mel_spectrogram
from ...models.rnnt import RNNTConfig, init_joint, init_predictor
from ...models.zipformer import ZipformerConfig, init_zipformer, zipformer_encode

__all__ = ["K2TorchModel", "load_model_container", "k2_forward", "default_k2_token_list",
           "BUCKET_SAMPLES", "DEFAULT_CHECKPOINT_ENV", "SECONDS_PER_FRAME"]

# the same variable as the JAX package: one converted tree serves both
DEFAULT_CHECKPOINT_ENV = "REAZONSPEECH_TPU_K2_CHECKPOINT"
BUCKET_SAMPLES = 4 * 16000

# Zipformer output frame rate: 10 ms fbank hop × 2 (embed) × 2 (output
# downsample) = 25 frames/sec, the grid sherpa timestamps live on.
SECONDS_PER_FRAME = 0.04


def k2_forward(params, waveform, lengths, fe_cfg: FrontendConfig, enc_cfg: ZipformerConfig,
               rnnt_cfg: RNNTConfig, decode_cfg):
    """waveform [B, N] float32, lengths [B] int (tensors on one device) ->
    (tokens [B, U], frames [B, U], counts [B], enc_lengths [B]). A
    ``BeamDecodeConfig`` decodes with ALSD, a ``GreedyDecodeConfig`` greedily."""
    feats, flens = log_mel_spectrogram(waveform, lengths, fe_cfg)
    enc, elens = zipformer_encode(params["encoder"], feats, flens, enc_cfg)
    if isinstance(decode_cfg, BeamDecodeConfig):
        tokens, frames, counts, _ = rnnt_beam_decode(
            params["predictor"], params["joint"], enc, elens, rnnt_cfg, decode_cfg)
    else:
        tokens, frames, counts = rnnt_greedy_decode(
            params["predictor"], params["joint"], enc, elens, rnnt_cfg, decode_cfg)
    return tokens, frames, counts, elens


@dataclass
class K2TorchModel:
    bucket_samples = BUCKET_SAMPLES  # the waveform padding grid (serving batchers read it)

    params: dict
    fe_cfg: FrontendConfig
    enc_cfg: ZipformerConfig
    rnnt_cfg: RNNTConfig
    decode_cfg: object  # GreedyDecodeConfig or BeamDecodeConfig
    tokenizer: object
    device: torch.device

    @property
    def token_list(self):
        return self.tokenizer.pieces

    def decode_batch_fn(self):
        """The per-shard pipeline ``(params, waveform, lengths) -> (tokens,
        frames, counts, enc_lengths)`` on tensors of one device, closing
        over the configs: what ``parallel.serving.DataParallelDecoder`` runs
        on each mesh entry."""
        fe_cfg, enc_cfg, rnnt_cfg, decode_cfg = (
            self.fe_cfg, self.enc_cfg, self.rnnt_cfg, self.decode_cfg)

        def fn(params, waveform, lengths):
            return k2_forward(params, waveform, lengths, fe_cfg, enc_cfg, rnnt_cfg, decode_cfg)

        return fn

    @torch.inference_mode()
    def decode_batch(self, waveforms: np.ndarray, lengths: np.ndarray):
        """Run the pipeline on a padded [B, N] batch; returns host numpy
        (tokens, frames, counts, enc_lengths)."""
        wav = torch.from_numpy(np.ascontiguousarray(waveforms, np.float32)).to(self.device)
        lens = torch.from_numpy(np.asarray(lengths, np.int32)).to(self.device)
        out = self.decode_batch_fn()(self.params, wav, lens)
        return tuple(x.cpu().numpy() for x in out)

    def decode_single(self, waveform: np.ndarray):
        """Decode one utterance, bucket-padded. Returns (token_ids, frames)."""
        n = len(waveform)
        padded_n = max(BUCKET_SAMPLES, -(-n // BUCKET_SAMPLES) * BUCKET_SAMPLES)
        buf = np.zeros((1, padded_n), np.float32)
        buf[0, :n] = waveform
        tokens, frames, counts, _ = self.decode_batch(buf, np.array([n]))
        c = int(counts[0])
        return tokens[0, :c].tolist(), frames[0, :c].tolist()


def default_k2_token_list():
    """k2 tokens.txt convention: <blk> first, then pieces."""
    pieces = ["<blk>", "<sos/eos>", "<unk>"]
    pieces += [chr(c) for c in range(0x3041, 0x3097)]
    pieces += [chr(c) for c in range(0x30A1, 0x30FB)]
    pieces += [chr(c) for c in range(0x4E00, 0x4E00 + 2000)]
    return pieces


def _cuda_serving_config(enc_cfg: ZipformerConfig) -> ZipformerConfig:
    """What the port serves on a GPU, as the reference serves on its TPU
    (``_tpu_serving_overrides``): the shared-attention kernels, bf16
    compute, fp32 residual stream."""
    return replace(enc_cfg, attn_impl="pallas", compute_dtype="bfloat16",
                   residual_dtype="float32")


def load_model_container(
    checkpoint: Optional[str] = None,
    enc_cfg: Optional[ZipformerConfig] = None,
    rnnt_cfg: Optional[RNNTConfig] = None,
    token_list=None,
    decoding: str = "greedy",
    beam_size: int = 4,
    seed: int = 0,
    device=None,
) -> K2TorchModel:
    """Build the k2-flavor container on ``device`` (default CUDA, which
    raises without a GPU; pass ``device="cpu"`` for the CPU).

    ``checkpoint`` is a converted-tree base path (fp32 or int8, written by
    either package), "random" (explicit random initialization for tests and
    benchmarks), or None, which consults $REAZONSPEECH_TPU_K2_CHECKPOINT and
    otherwise raises (the HF-hub resolution lives in load_model,
    k2/asr/huggingface.py). On CUDA, an encoder config not passed explicitly
    is the serving configuration (see module notes). ``decoding="beam"``
    decodes with ALSD beam search of ``beam_size`` over the stateless
    predictor, as the reference; its opt-in kernels stay off (replace
    ``decode_cfg`` to set ``joint_impl``).
    """
    if decoding not in ("greedy", "beam"):
        raise ValueError(f"Unknown decoding: '{decoding}'")
    device = resolve_device(device)
    on_cuda = device.type == "cuda"
    if on_cuda:
        set_fp32_matmul_policy()
    checkpoint = checkpoint or os.environ.get(DEFAULT_CHECKPOINT_ENV)
    meta, params = {}, None
    if checkpoint != "random":
        if checkpoint is None:
            raise CheckpointNotFoundError(
                "No k2 checkpoint given (pass checkpoint=, set $%s, or use "
                "k2.asr.load_model for HF-hub resolution). For a randomly "
                "initialized model pass checkpoint=\"random\"." % DEFAULT_CHECKPOINT_ENV)
        tree, meta = load_param_tree(checkpoint)
        if is_quantized(tree):  # int8 precision variants
            tree = dequantize_tree(tree)
        params = params_from_numpy(tree, device)
        if meta.get("token_list"):
            token_list = token_list or meta["token_list"]

    if enc_cfg is None:
        serving = _cuda_serving_config if on_cuda else (lambda cfg: cfg)
        enc_cfg = serving(ZipformerConfig(**{k: tuple(v) if isinstance(v, list) else v
                                             for k, v in meta.get("enc_cfg", {}).items()}))

    token_list = token_list or default_k2_token_list()
    if rnnt_cfg is None and meta.get("rnnt_cfg"):
        rnnt_cfg = RNNTConfig(**meta["rnnt_cfg"])
    if rnnt_cfg is None:
        rnnt_cfg = RNNTConfig(
            vocab_size=len(token_list), enc_dim=enc_cfg.out_dim, pred_hidden=512,
            joint_hidden=512, joint_activation="tanh", predictor_kind="stateless",
            context_size=2)

    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = {
            "encoder": init_zipformer(gen, enc_cfg, device),
            "predictor": init_predictor(gen, rnnt_cfg, device),
            "joint": init_joint(gen, rnnt_cfg, device),
        }

    return K2TorchModel(
        params=params, fe_cfg=kaldi_frontend_config(n_mels=enc_cfg.feat_in), enc_cfg=enc_cfg,
        rnnt_cfg=rnnt_cfg,
        decode_cfg=BeamDecodeConfig(beam_size=beam_size) if decoding == "beam"
        else GreedyDecodeConfig(),
        tokenizer=VocabTokenizer(token_list), device=device)
