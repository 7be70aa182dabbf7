"""Model container and end-to-end pipeline for the nemo-v2 flavor (PyTorch).

Port of ``reazonspeech_tpu.nemo.asr.model``: log-mel frontend →
FastConformer encoder → ALSD beam search (or label-looping greedy) →
(token, frame) emissions. The waveform is the only host→device copy and the
emission buffers the only device→host copy of a batch.

On a CUDA device, ``load_model`` serves the reference's serving
configuration on the Hopper kernels: the LayerNorm-fused projections
(FFN-in, packed q/k/v with the residual add), packed rel-pos attention, the
conv module with its LayerNorm inside, the fused residual tail, bf16
matmuls with fp32 accumulation, an fp32 residual stream, and the fused
top-m kernel in the ALSD loop. On the CPU it runs the plain formulas.
"""

import glob
import os
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ...convert.from_jax import params_from_numpy
from ...convert.nemo_fastconformer import convert_nemo_checkpoint
from ...convert.store import load_param_tree
from ...core.hub import CheckpointNotFoundError, resolve_converted
from ...core.tokenizer import CharTokenizer, SentencePieceTokenizer
from ...decoding.rnnt_beam import BeamDecodeConfig, rnnt_beam_decode
from ...decoding.rnnt_greedy import GreedyDecodeConfig, rnnt_greedy_decode
from ...device import resolve_device, set_fp32_matmul_policy
from ...frontend.features import FrontendConfig, log_mel_spectrogram, nemo_frontend_config
from ...models.fastconformer import FastConformerConfig, fastconformer_encode, init_fastconformer
from ...models.rnnt import RNNTConfig, init_joint, init_predictor

__all__ = ["NemoTorchModel", "load_model", "asr_forward", "init_params",
           "BUCKET_SAMPLES", "DEFAULT_CHECKPOINT_ENV"]

# the same variable and converted-tree cache as the JAX package: one
# converted tree serves both
DEFAULT_CHECKPOINT_ENV = "REAZONSPEECH_TPU_NEMO_CHECKPOINT"
HF_REPO_ID = "reazon-research/reazonspeech-nemo-v2"

# waveforms are padded to multiples of this many samples
BUCKET_SAMPLES = 4 * 16000


def asr_forward(params, waveform, lengths, fe_cfg: FrontendConfig,
                enc_cfg: FastConformerConfig, rnnt_cfg: RNNTConfig, decode_cfg):
    """waveform [B, N] float32, lengths [B] int (tensors on one device) ->
    (tokens [B, U], frames [B, U], counts [B], enc_lengths [B])."""
    feats, feat_lens = log_mel_spectrogram(waveform, lengths, fe_cfg)
    enc, enc_lens = fastconformer_encode(params["encoder"], feats, feat_lens, enc_cfg)
    if isinstance(decode_cfg, BeamDecodeConfig):
        tokens, frames, counts, _ = rnnt_beam_decode(
            params["predictor"], params["joint"], enc, enc_lens, rnnt_cfg, decode_cfg)
    else:
        tokens, frames, counts = rnnt_greedy_decode(
            params["predictor"], params["joint"], enc, enc_lens, rnnt_cfg, decode_cfg)
    return tokens, frames, counts, enc_lens


def default_ja_tokenizer(vocab_size: int) -> CharTokenizer:
    """The JAX package's deterministic Japanese character vocabulary, for
    models without a tokenizer (random weights, tests)."""
    chars = ["<unk>", "▁", "。", "、", "?", "!", ","]
    chars += [chr(c) for c in range(0x3041, 0x3097)]  # hiragana
    chars += [chr(c) for c in range(0x30A1, 0x30FB)]  # katakana
    chars += [chr(c) for c in range(0x4E00, 0x4E00 + max(0, vocab_size))]  # kanji
    tok = CharTokenizer(chars[:vocab_size])
    tok.types[0] = 2  # <unk>
    return tok


@dataclass
class NemoTorchModel:
    bucket_samples = BUCKET_SAMPLES  # the waveform padding grid (serving batchers read it)

    params: dict
    fe_cfg: FrontendConfig
    enc_cfg: FastConformerConfig
    rnnt_cfg: RNNTConfig
    decode_cfg: object
    tokenizer: object
    device: torch.device

    def decode_batch_fn(self):
        """The per-shard pipeline ``(params, waveform, lengths) -> (tokens,
        frames, counts, enc_lengths)`` on tensors of one device, closing
        over the configs: what ``parallel.serving.DataParallelDecoder`` runs
        on each mesh entry."""
        fe_cfg, enc_cfg, rnnt_cfg, decode_cfg = (
            self.fe_cfg, self.enc_cfg, self.rnnt_cfg, self.decode_cfg)

        def fn(params, waveform, lengths):
            return asr_forward(params, waveform, lengths, fe_cfg, enc_cfg, rnnt_cfg, decode_cfg)

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


def init_params(seed: int, enc_cfg: FastConformerConfig, rnnt_cfg: RNNTConfig,
                device="cpu"):
    """Random weights from ``torch.Generator(seed)``, the reference's tree and
    distributions (not its values: the generators differ)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {
        "encoder": init_fastconformer(gen, enc_cfg, device),
        "predictor": init_predictor(gen, rnnt_cfg, device),
        "joint": init_joint(gen, rnnt_cfg, device),
    }


def _cuda_serving_config(enc_cfg: FastConformerConfig) -> FastConformerConfig:
    """What the port serves on a GPU, as the reference serves on its TPU
    (``_tpu_serving_overrides``): every encoder kernel (attention, conv
    module, and the LayerNorms fused into the kernels after them), bf16
    compute, fp32 residual stream (a bf16 stream flipped 78% of greedy
    tokens in the reference's parity gate)."""
    return replace(enc_cfg, attn_impl="pallas", conv_impl="pallas", lnd_impl="pallas",
                   compute_dtype="bfloat16", residual_dtype="float32")


def _convert_snapshot(snapshot_dir, out_base):
    """Convert the .nemo archive inside an HF snapshot to a native tree."""
    cands = sorted(glob.glob(os.path.join(snapshot_dir, "**", "*.nemo"), recursive=True))
    if not cands:
        raise CheckpointNotFoundError(f"HF snapshot {snapshot_dir} contains no .nemo archive")
    convert_nemo_checkpoint(cands[0], out_base)


def load_model(device=None, *, checkpoint: Optional[str] = None,
               enc_cfg: Optional[FastConformerConfig] = None,
               rnnt_cfg: Optional[RNNTConfig] = None, decode_cfg=None,
               decoding: Optional[str] = None, beam_size: Optional[int] = None,
               tokenizer=None, seed: int = 0) -> NemoTorchModel:
    """Load the nemo-v2 flavor model onto ``device`` (default CUDA, which
    raises without a GPU; pass ``device="cpu"`` for the CPU).

    Weights: ``checkpoint=`` path > $REAZONSPEECH_TPU_NEMO_CHECKPOINT > the
    converted-tree cache shared with the JAX package > a locally cached HF
    snapshot of reazonspeech-nemo-v2, whose ``.nemo`` archive is converted
    (``convert/nemo_fastconformer.py``) and cached on the first load. With
    nothing found this raises CheckpointNotFoundError; random weights are
    opt-in with ``checkpoint="random"``. The port never downloads.

    ``decoding``: "alsd"/"beam" (default, NeMo's ALSD beam search) or
    "greedy". On CUDA, configs not passed explicitly default to the kernel
    serving configuration (see module notes).
    """
    device = resolve_device(device)
    on_cuda = device.type == "cuda"
    if on_cuda:
        set_fp32_matmul_policy()
    checkpoint = checkpoint or os.environ.get(DEFAULT_CHECKPOINT_ENV)
    meta, params = {}, None
    if checkpoint != "random":
        if checkpoint is None:
            checkpoint = resolve_converted(HF_REPO_ID, "model", _convert_snapshot,
                                           require=("*.nemo",))
        tree, meta = load_param_tree(checkpoint)
        params = params_from_numpy(tree, device)
        if tokenizer is None and meta.get("tokenizer_model"):
            tokenizer = SentencePieceTokenizer.from_model_file(meta["tokenizer_model"])

    if enc_cfg is None:
        enc_cfg = FastConformerConfig(**meta.get("enc_cfg", {}))
        if on_cuda:
            enc_cfg = _cuda_serving_config(enc_cfg)
    if rnnt_cfg is None:
        rnnt_cfg = RNNTConfig(**meta["rnnt_cfg"]) if meta.get("rnnt_cfg") \
            else RNNTConfig(enc_dim=enc_cfg.d_model)
    if decode_cfg is None:
        ck_dec = meta.get("decoding") or {}
        decoding = decoding or ck_dec.get("strategy", "alsd")
        if decoding in ("alsd", "beam"):
            decode_cfg = BeamDecodeConfig(
                beam_size=beam_size or ck_dec.get("beam_size", 4),
                alsd_max_target_len=ck_dec.get("alsd_max_target_len", 1.0),
                score_norm=ck_dec.get("score_norm", True),
                topk_impl="pallas" if on_cuda else "xla",
            )
        else:
            decode_cfg = GreedyDecodeConfig()

    if params is None:
        params = init_params(seed, enc_cfg, rnnt_cfg, device)
    if tokenizer is None:
        tokenizer = default_ja_tokenizer(rnnt_cfg.vocab_size)
    return NemoTorchModel(
        params=params, fe_cfg=nemo_frontend_config(n_mels=enc_cfg.feat_in),
        enc_cfg=enc_cfg, rnnt_cfg=rnnt_cfg, decode_cfg=decode_cfg,
        tokenizer=tokenizer, device=device)
