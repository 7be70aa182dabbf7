"""espnet-flavor model container: Conformer encoder + CTC head + transducer
(PyTorch).

Port of ``reazonspeech_tpu.espnet.asr.model``: log-mel (espnet preset) →
GlobalMVN → Conformer encoder (``models/conformer.py``) → one encoder pass
shared by the CTC head (blank detection, alignment) and the transducer
decode: Graves beam search (ESPnet's ``default_beam_search``, beam 20, the
default), mAES (ESPnet's ``search_type="maes"``), ALSD or greedy.

On a CUDA device, ``load_model_container`` serves the reference's TPU
serving configuration (``_tpu_serving_overrides``): the attention, conv
module and LayerNorm-fused kernels, bf16 compute, an fp32 residual stream,
and the top-m kernel in the beam search. At espnet's 20 s window (T=549
encoder frames) the attention takes the reference's [B, H, T, dh] route
(``fastconformer.attention_route``). On the CPU it runs the plain formulas.
"""

import glob
import os
import warnings
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ...convert.espnet_conformer import convert_espnet_checkpoint
from ...convert.from_jax import params_from_numpy
from ...convert.store import load_param_tree
from ...core.hub import CheckpointNotFoundError, resolve_converted
from ...core.tokenizer import CharTokenizer
from ...decoding.rnnt_beam import BeamDecodeConfig, rnnt_beam_decode
from ...decoding.rnnt_greedy import GreedyDecodeConfig, rnnt_greedy_decode
from ...decoding.transducer_graves import GravesBeamConfig, graves_beam_decode
from ...decoding.transducer_maes import MAESBeamConfig, maes_beam_decode
from ...device import resolve_device, set_fp32_matmul_policy
from ...frontend.features import FrontendConfig, espnet_frontend_config, log_mel_spectrogram
from ...models.conformer import (
    ctc_log_softmax, ctc_softmax, espnet_encoder_config, init_ctc_head,
)
from ...models.fastconformer import FastConformerConfig, fastconformer_encode, init_fastconformer
from ...models.rnnt import RNNTConfig, init_joint, init_predictor

__all__ = ["EspnetTorchModel", "load_model_container", "encode_ctc_decode", "encode_ctc",
           "default_token_list", "BUCKET_SAMPLES", "DEFAULT_CHECKPOINT_ENV"]

# the same variable and converted-tree cache as the JAX package: one
# converted tree serves both
DEFAULT_CHECKPOINT_ENV = "REAZONSPEECH_TPU_ESPNET_CHECKPOINT"
HF_REPO_ID = "reazon-research/reazonspeech-espnet-v2"
BUCKET_SAMPLES = 2 * 16000  # chunks are ≤ 20 s; 2 s buckets


def _apply_mvn(params, feats, flens):
    """GlobalMVN feature normalization from ``params["normalize"]`` (the
    corpus statistics the converter folds in). Padded frames are zeroed
    again: the subsampling convs must not see the normalized-zero bias."""
    if "normalize" not in params:
        return feats
    n = params["normalize"]
    out = (feats - n["mean"]) / n["std"]
    mask = torch.arange(feats.shape[1], device=feats.device)[None, :] < flens[:, None]
    return torch.where(mask[..., None], out, 0.0)


def _encode(params, waveform, lengths, fe_cfg, enc_cfg):
    feats, flens = log_mel_spectrogram(waveform, lengths, fe_cfg)
    feats = _apply_mvn(params, feats, flens)
    return fastconformer_encode(params["encoder"], feats, flens, enc_cfg)


def encode_ctc_decode(params, waveform, lengths, fe_cfg: FrontendConfig,
                      enc_cfg: FastConformerConfig, rnnt_cfg: RNNTConfig, decode_cfg):
    """One encoder pass: frontend → encoder → (CTC log-probs [B, T, V],
    tokens [B, U], frames [B, U], counts [B], enc_lengths [B], saturated
    [B]); ``saturated`` marks elements where the beam search's pop cap ended
    a frame before ESPnet's own termination test."""
    enc, elens = _encode(params, waveform, lengths, fe_cfg, enc_cfg)
    lpz_log = ctc_log_softmax(params["ctc"], enc)
    saturated = torch.zeros((enc.shape[0],), dtype=torch.bool, device=enc.device)
    pp, jp = params["predictor"], params["joint"]
    if isinstance(decode_cfg, GravesBeamConfig):
        tokens, frames, counts, _, saturated = graves_beam_decode(
            pp, jp, enc, elens, rnnt_cfg, decode_cfg)
    elif isinstance(decode_cfg, MAESBeamConfig):
        tokens, frames, counts, _ = maes_beam_decode(pp, jp, enc, elens, rnnt_cfg, decode_cfg)
    elif isinstance(decode_cfg, BeamDecodeConfig):
        tokens, frames, counts, _ = rnnt_beam_decode(pp, jp, enc, elens, rnnt_cfg, decode_cfg)
    else:
        tokens, frames, counts = rnnt_greedy_decode(pp, jp, enc, elens, rnnt_cfg, decode_cfg)
    return lpz_log, tokens, frames, counts, elens, saturated


def encode_ctc(params, waveform, lengths, fe_cfg: FrontendConfig, enc_cfg: FastConformerConfig):
    """frontend → encoder → CTC softmax probabilities (the lpz matrix)."""
    enc, elens = _encode(params, waveform, lengths, fe_cfg, enc_cfg)
    return ctc_softmax(params["ctc"], enc), elens


def _warn_saturated(saturated):
    """Warn when the fixed-shape beam's pop budget bound (ESPnet's search is
    unbounded; the cap keeps shapes static)."""
    n = int(np.asarray(saturated).sum())
    if n:
        warnings.warn(
            f"beam search pop budget was exhausted on {n} batch element(s) "
            "before ESPnet's termination test; results there may diverge "
            "from the reference. Raise GravesBeamConfig.max_pops_per_frame "
            "to remove the bound.",
            RuntimeWarning,
            stacklevel=3,
        )


@dataclass
class EspnetTorchModel:
    bucket_samples = BUCKET_SAMPLES  # the waveform padding grid (serving batchers read it)

    params: dict
    fe_cfg: FrontendConfig
    enc_cfg: FastConformerConfig
    rnnt_cfg: RNNTConfig
    decode_cfg: object
    tokenizer: object  # CharTokenizer over token_list
    device: torch.device
    blank_id: int = 0  # CTC blank (espnet convention)

    @property
    def token_list(self):
        return self.tokenizer.pieces

    def _bucket(self, samples):
        n = len(samples)
        padded = max(BUCKET_SAMPLES, -(-n // BUCKET_SAMPLES) * BUCKET_SAMPLES)
        buf = np.zeros((1, padded), np.float32)
        buf[0, :n] = samples
        return buf, np.array([n], np.int32)

    def _to_device(self, waveforms, lengths):
        wav = torch.from_numpy(np.ascontiguousarray(waveforms, np.float32)).to(self.device)
        lens = torch.from_numpy(np.asarray(lengths, np.int32)).to(self.device)
        return wav, lens

    @torch.inference_mode()
    def ctc_probs(self, samples):
        """lpz [T_valid, V] softmax probabilities (host numpy) for a chunk."""
        lpz, elens = encode_ctc(self.params, *self._to_device(*self._bucket(samples)),
                                self.fe_cfg, self.enc_cfg)
        return lpz[0, :int(elens[0])].cpu().numpy()

    @torch.inference_mode()
    def decode_with_ctc(self, samples):
        """(token_ids, lpz_log [T_valid, V] on the model's device) for a
        chunk: one encoder pass shared by decode and alignment."""
        lpz_log, tokens, _, counts, elens, saturated = encode_ctc_decode(
            self.params, *self._to_device(*self._bucket(samples)), self.fe_cfg, self.enc_cfg,
            self.rnnt_cfg, self.decode_cfg)
        _warn_saturated(saturated.cpu().numpy())
        return tokens[0, :int(counts[0])].tolist(), lpz_log[0, :int(elens[0])]

    def ids_to_text(self, ids):
        return self.tokenizer.ids_to_text(ids)

    def decode_batch_fn(self):
        """The per-shard pipeline ``(params, waveform, lengths) -> (tokens,
        frames, counts, enc_lengths, saturated)`` on tensors of one device,
        closing over the configs: what ``parallel.serving.DataParallelDecoder``
        runs on each mesh entry. The CTC matrix is not returned."""
        fe_cfg, enc_cfg, rnnt_cfg, decode_cfg = (
            self.fe_cfg, self.enc_cfg, self.rnnt_cfg, self.decode_cfg)

        def fn(params, waveform, lengths):
            return encode_ctc_decode(params, waveform, lengths, fe_cfg, enc_cfg, rnnt_cfg,
                                     decode_cfg)[1:]

        return fn

    def _host_decode_flags(self, outs):
        """Host-side post of :meth:`decode_batch_fn`'s outputs (numpy): warn
        on the elements whose pop budget saturated (the 5th output)."""
        if len(outs) > 4:
            _warn_saturated(outs[4])

    @torch.inference_mode()
    def decode_batch(self, waveforms: np.ndarray, lengths: np.ndarray):
        """Padded-batch transducer decode: returns host numpy (tokens,
        frames, counts, enc_lengths)."""
        outs = self.decode_batch_fn()(self.params, *self._to_device(waveforms, lengths))
        outs = tuple(x.cpu().numpy() for x in outs)
        self._host_decode_flags(outs)
        return outs[:4]

    def decode_single(self, waveform: np.ndarray):
        """Decode one utterance, bucket-padded. Returns (token_ids, frames)."""
        buf, lens = self._bucket(np.asarray(waveform, np.float32))
        tokens, frames, counts, _ = self.decode_batch(buf, lens)
        c = int(counts[0])
        return tokens[0, :c].tolist(), frames[0, :c].tolist()


def default_token_list(vocab_chars=None):
    """espnet-convention token list: <blank> first, <sos/eos> last."""
    if vocab_chars is None:
        chars = ["。", "、", "?", "!"]
        chars += [chr(c) for c in range(0x3041, 0x3097)]
        chars += [chr(c) for c in range(0x30A1, 0x30FB)]
        chars += [chr(c) for c in range(0x4E00, 0x4E00 + 2000)]
        vocab_chars = chars
    return ["<blank>"] + list(vocab_chars) + ["<sos/eos>"]


def _cuda_serving_config(enc_cfg: FastConformerConfig) -> FastConformerConfig:
    """What the port serves on a GPU, as the reference serves on its TPU
    (``_tpu_serving_overrides``): the attention, conv-module and
    LayerNorm-fused kernels, bf16 compute, fp32 residual stream."""
    return replace(enc_cfg, attn_impl="pallas", conv_impl="pallas", lnd_impl="pallas",
                   compute_dtype="bfloat16", residual_dtype="float32")


def _convert_snapshot(snapshot_dir, out_base):
    """Convert the espnet-zoo .pth (+ its config.yaml) inside an HF snapshot."""
    pths = sorted(
        glob.glob(os.path.join(snapshot_dir, "**", "*.pth"), recursive=True),
        # prefer the averaged validation checkpoint the zoo publishes
        key=lambda p: ("valid" not in p, "ave" not in p, p),
    )
    if not pths:
        raise CheckpointNotFoundError(f"HF snapshot {snapshot_dir} contains no .pth checkpoint")
    cfg_candidates = glob.glob(os.path.join(os.path.dirname(pths[0]), "config.yaml")) \
        or glob.glob(os.path.join(snapshot_dir, "**", "config.yaml"), recursive=True)
    convert_espnet_checkpoint(pths[0], out_base,
                              config_yaml=cfg_candidates[0] if cfg_candidates else None)


def load_model_container(
    checkpoint: Optional[str] = None,
    enc_cfg: Optional[FastConformerConfig] = None,
    rnnt_cfg: Optional[RNNTConfig] = None,
    token_list=None,
    decoding: str = "beam",
    beam_size: int = 20,
    seed: int = 0,
    device=None,
) -> EspnetTorchModel:
    """Build the espnet-flavor container on ``device`` (default CUDA, which
    raises without a GPU; pass ``device="cpu"`` for the CPU).

    ``decoding``: "beam" (the default: ESPnet's ``default_beam_search`` at
    width 20, Graves), "maes" (ESPnet's alignment-synchronous mAES at width
    ``beam_size``), "alsd" (the NeMo-style alignment-synchronous beam) or
    "greedy". On CUDA the beam searches take the top-m kernel.

    Weights: ``checkpoint=`` path > $REAZONSPEECH_TPU_ESPNET_CHECKPOINT > the
    converted-tree cache shared with the JAX package > a locally cached HF
    snapshot of reazonspeech-espnet-v2, whose ``.pth`` and ``config.yaml``
    are converted (``convert/espnet_conformer.py``) and cached on the first
    load. With nothing found this raises CheckpointNotFoundError; random
    weights are opt-in with ``checkpoint="random"``. The port never
    downloads. On CUDA,
    an encoder config not passed explicitly is the serving configuration
    (see module notes).
    """
    if decoding not in ("beam", "maes", "alsd", "greedy"):
        raise ValueError(f"Unknown decoding: '{decoding}'")
    device = resolve_device(device)
    on_cuda = device.type == "cuda"
    if on_cuda:
        set_fp32_matmul_policy()
    checkpoint = checkpoint or os.environ.get(DEFAULT_CHECKPOINT_ENV)
    meta, params = {}, None
    if checkpoint != "random":
        if checkpoint is None:
            checkpoint = resolve_converted(HF_REPO_ID, "model", _convert_snapshot,
                                           require=("*.pth",))
        tree, meta = load_param_tree(checkpoint)
        params = params_from_numpy(tree, device)
        if meta.get("token_list"):
            token_list = token_list or meta["token_list"]

    if enc_cfg is None:
        enc_cfg = FastConformerConfig(**meta["enc_cfg"]) if meta.get("enc_cfg") \
            else espnet_encoder_config()
        if on_cuda:
            enc_cfg = _cuda_serving_config(enc_cfg)

    token_list = token_list or default_token_list()
    num_tokens = len(token_list)
    if rnnt_cfg is None and meta.get("rnnt_cfg"):
        rnnt_cfg = RNNTConfig(**meta["rnnt_cfg"])
    if rnnt_cfg is None:
        # espnet2 TransducerDecoder/JointNetwork conventions: blank id 0
        # shares the embedding table, tanh joint
        hidden = 256 if enc_cfg.d_model >= 256 else 64
        rnnt_cfg = RNNTConfig(vocab_size=num_tokens, enc_dim=enc_cfg.d_model, pred_hidden=hidden,
                              joint_hidden=hidden, joint_activation="tanh",
                              blank_position="first")

    gen = torch.Generator(device=device).manual_seed(seed)
    if params is None:
        params = {"encoder": init_fastconformer(gen, enc_cfg, device)}
    # a CTC-only or encoder-only conversion still needs usable shapes for
    # the transducer branch of the pass
    for name, init in (("ctc", lambda: init_ctc_head(gen, enc_cfg.d_model, num_tokens, device)),
                       ("predictor", lambda: init_predictor(gen, rnnt_cfg, device)),
                       ("joint", lambda: init_joint(gen, rnnt_cfg, device))):
        if name not in params:
            params[name] = init()

    tok = CharTokenizer(token_list)
    tok.types[0] = 3  # <blank> control
    tok.types[-1] = 3  # <sos/eos> control

    topk_impl = "pallas" if on_cuda else "xla"
    if decoding == "beam":
        decode_cfg = GravesBeamConfig(beam_size=beam_size, topk_impl=topk_impl)
    elif decoding == "maes":
        decode_cfg = MAESBeamConfig(beam_size=beam_size, topk_impl=topk_impl)
    elif decoding == "alsd":
        decode_cfg = BeamDecodeConfig(beam_size=beam_size, topk_impl=topk_impl)
    else:
        decode_cfg = GreedyDecodeConfig()

    return EspnetTorchModel(
        params=params, fe_cfg=espnet_frontend_config(n_mels=enc_cfg.feat_in), enc_cfg=enc_cfg,
        rnnt_cfg=rnnt_cfg, decode_cfg=decode_cfg, tokenizer=tok, device=device)
