"""AVHuBERT feature extraction (host-side).

A copy of ``reazonspeech_tpu/avsr/feature_extraction.py`` with the same
behaviour; the mel filterbank is the port's own (``frontend/mel.py``).

Behavior parity with the reference extractor (pkg/avsr/src/avhubert/
feature_extraction_avhubert.py:55-224):

- audio: 26-dim log-fbank at 100 Hz (0.025 s window / 0.01 s step,
  rectangular window, HTK mel, preemph 0.97 — python_speech_features
  semantics, implemented first-party) stacked ×4 → 104-dim @ 25 Hz;
- video: frames → grayscale → mouth ROI (mediapipe FaceMesh landmarks
  5/411/199/187 when the package is present; center square crop fallback) →
  88×88;
- A/V length alignment by index interpolation;
- batch zero-padding with a padding mask, per-utterance layer norm of audio
  features, video normalization (mean 0.421 / std 0.165).
"""

import numpy as np

from ..frontend.mel import mel_filterbank

__all__ = ["AVHubertFeatureExtractor", "logfbank", "stack_features"]

AUDIO_MEAN_STD = (0.421, 0.165)  # video pixel normalization


def _framesig(signal, frame_len, frame_step):
    """python_speech_features-style framing: ceil frame count, zero pad."""
    n = len(signal)
    if n <= frame_len:
        num = 1
    else:
        num = 1 + int(np.ceil((n - frame_len) / frame_step))
    pad = (num - 1) * frame_step + frame_len - n
    padded = np.concatenate([signal, np.zeros(pad, signal.dtype)])
    idx = (
        np.arange(frame_len)[None, :]
        + np.arange(num)[:, None] * frame_step
    )
    return padded[idx]


def logfbank(
    signal,
    samplerate=16000,
    winlen=0.025,
    winstep=0.01,
    nfilt=26,
    nfft=512,
    preemph=0.97,
):
    """26-dim log mel filterbank energies, python_speech_features semantics
    (rectangular window, HTK mel, power spectrum scaled by 1/nfft)."""
    signal = np.asarray(signal, np.float64)
    signal = np.append(signal[0], signal[1:] - preemph * signal[:-1])
    frames = _framesig(signal, int(winlen * samplerate), int(winstep * samplerate))
    spec = np.abs(np.fft.rfft(frames, nfft, axis=1)) ** 2 / nfft
    fb = mel_filterbank(
        nfilt, nfft, samplerate, fmin=0, fmax=samplerate / 2,
        scale="htk", norm=None, triangle_domain="hz", dtype=np.float64,
    )
    feat = spec @ fb.T
    feat = np.where(feat == 0, np.finfo(np.float64).eps, feat)
    return np.log(feat).astype(np.float32)


def stack_features(feats, stack_order=4):
    """[T, F] -> [T//stack, F*stack] (zero-pad T to a multiple)."""
    t, f = feats.shape
    pad = (-t) % stack_order
    if pad:
        feats = np.concatenate([feats, np.zeros((pad, f), feats.dtype)])
    return feats.reshape(-1, stack_order * f)


def _load_video_frames(path_or_frames):
    """Return [T, H, W] grayscale uint8/float frames."""
    if isinstance(path_or_frames, np.ndarray):
        frames = path_or_frames
        if frames.ndim == 4:  # [T, H, W, C] -> grayscale
            frames = frames.mean(axis=-1)
        return frames.astype(np.float32)
    import cv2

    cap = cv2.VideoCapture(str(path_or_frames))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
    cap.release()
    return np.asarray(frames, np.float32)


def _mouth_roi(frames, size=88):
    """Crop the mouth region of interest.

    With mediapipe present: FaceMesh landmarks (5, 411, 199, 187) bound a
    square patch (reference feature_extraction_avhubert.py:79-120); without
    it, a centered square crop (and zeros when frames are empty).
    """
    if len(frames) == 0:
        return np.zeros((0, size, size), np.float32)
    try:
        import mediapipe as mp

        return _mouth_roi_mediapipe(frames, size, mp)
    except ImportError:
        pass
    import cv2

    t, h, w = frames.shape
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    out = np.zeros((t, size, size), np.float32)
    for i in range(t):
        patch = frames[i, y0 : y0 + s, x0 : x0 + s]
        out[i] = cv2.resize(patch, (size, size))
    return out


def mouth_crop_box(xs, ys, h, w):
    """Square mouth crop box from normalized landmark coordinates.

    EXACT reference arithmetic (feature_extraction_avhubert.py:99-113):
    patch side = max(x-extent·W, y-extent·H); ``half`` and the center are
    truncated to int in the same order; the box may extend out of bounds or
    be degenerate — numpy slicing semantics downstream are part of the
    behavior (the reference zero-fills when the resize then fails).

    Returns (y0, y1, x0, x1).
    """
    xmax, xmin = max(xs), min(xs)
    ymax, ymin = max(ys), min(ys)
    patch_size = max((xmax - xmin) * w, (ymax - ymin) * h)
    half = int(patch_size / 2)
    y_center = int(ymin * h) + int(((ymax - ymin) / 2) * h)
    x_center = int(xmin * w) + int(((xmax - xmin) / 2) * w)
    return y_center - half, y_center + half, x_center - half, x_center + half


# FaceMesh landmark ids bounding the mouth: top, right, bottom, left
# (reference feature_extraction_avhubert.py landmark_indices default).
MOUTH_LANDMARKS = (5, 411, 199, 187)


def _mouth_roi_mediapipe(frames, size, mp):
    import cv2

    out = np.zeros((len(frames), size, size), np.float32)
    with mp.solutions.face_mesh.FaceMesh(
        static_image_mode=False, max_num_faces=1
    ) as mesh:
        for i, frame in enumerate(frames):
            rgb = cv2.cvtColor(frame.astype(np.uint8), cv2.COLOR_GRAY2RGB)
            res = mesh.process(rgb)
            if not res.multi_face_landmarks:
                continue  # zeros on no face (reference appends a zero frame)
            lm = res.multi_face_landmarks[0].landmark
            h, w = frame.shape
            xs = [lm[j].x for j in MOUTH_LANDMARKS]
            ys = [lm[j].y for j in MOUTH_LANDMARKS]
            y0, y1, x0, x1 = mouth_crop_box(xs, ys, h, w)
            patch = frame[y0:y1, x0:x1]
            if patch.size == 0:
                continue  # zeros, like the reference's resize-failure path
            out[i] = cv2.resize(patch, (size, size))
    return out


def _align_time_steps(audio_feats, video_frames):
    """Resample video frames to the audio step count by index interpolation
    (reference feature_extraction_avhubert.py:141-159)."""
    ta = len(audio_feats)
    tv = len(video_frames)
    if tv == 0 or ta == tv:
        return audio_feats, video_frames
    idx = np.round(np.linspace(0, tv - 1, ta)).astype(int)
    return audio_feats, video_frames[idx]


class AVHubertFeatureExtractor:
    """Extract paired (audio_feats, video_frames) model inputs."""

    def __init__(
        self,
        sampling_rate=16000,
        stack_order_audio=4,
        image_crop_size=88,
        image_mean=AUDIO_MEAN_STD[0],
        image_std=AUDIO_MEAN_STD[1],
        **kwargs,
    ):
        self.sampling_rate = sampling_rate
        self.stack_order_audio = stack_order_audio
        self.image_crop_size = image_crop_size
        self.image_mean = image_mean
        self.image_std = image_std

    def _extract_audio(self, waveform):
        feats = logfbank(np.asarray(waveform, np.float32), self.sampling_rate)
        return stack_features(feats, self.stack_order_audio)

    def _extract_video(self, video, extract_mouth=True):
        frames = _load_video_frames(video)
        if extract_mouth:
            frames = _mouth_roi(frames, self.image_crop_size)
        if frames.max() > 1.5:  # uint8 range
            frames = frames / 255.0
        return (frames - self.image_mean) / self.image_std

    def __call__(self, audios=None, videos=None, extract_mouth=True,
                 return_tensors=None):
        """Batch-extract features.

        Args:
          audios: list of 16 kHz waveforms (or None)
          videos: list of video paths / [T,H,W(,C)] arrays (or None)

        Returns:
          dict(audio_feats [B, T, 104] | None, video_frames [B, T, 88, 88]
          | None, padding_mask [B, T] bool, lengths [B])
        """
        if audios is None and videos is None:
            raise ValueError("provide audios and/or videos")
        n = len(audios) if audios is not None else len(videos)

        a_list = [self._extract_audio(a) for a in audios] if audios is not None else None
        v_list = (
            [self._extract_video(v, extract_mouth) for v in videos]
            if videos is not None
            else None
        )
        if a_list is not None and v_list is not None:
            pairs = [_align_time_steps(a, v) for a, v in zip(a_list, v_list)]
            a_list = [p[0] for p in pairs]
            v_list = [p[1] for p in pairs]

        ref = a_list if a_list is not None else v_list
        lengths = np.array([len(x) for x in ref], np.int32)
        t_max = int(lengths.max())

        out = {"lengths": lengths}
        mask = np.arange(t_max)[None, :] < lengths[:, None]
        out["padding_mask"] = mask

        if a_list is not None:
            batch = np.zeros((n, t_max, a_list[0].shape[1]), np.float32)
            for i, a in enumerate(a_list):
                # per-utterance layer norm of audio features
                mu, sd = a.mean(), a.std() + 1e-5
                batch[i, : len(a)] = (a - mu) / sd
            out["audio_feats"] = batch
        else:
            out["audio_feats"] = None

        if v_list is not None:
            s = self.image_crop_size
            vb = np.zeros((n, t_max, s, s), np.float32)
            for i, v in enumerate(v_list):
                vb[i, : len(v)] = v[:t_max]
            out["video_frames"] = vb
        else:
            out["video_frames"] = None
        return out
