"""AVHuBERT processor: pairs the feature extractor with a tokenizer.

A copy of ``reazonspeech_tpu/avsr/processing.py`` with the same behaviour.

Behavior parity with the reference processor (pkg/avsr/src/avhubert/
processing_avhubert.py:31-118): feature extraction for inputs, ``<s>…</s>``
normalization of target texts, teacher-forcing split (decoder inputs drop the
last token, labels drop the first), decode/batch_decode passthrough.
"""

import numpy as np

from .feature_extraction import AVHubertFeatureExtractor

__all__ = ["AVHubertProcessor"]


class AVHubertProcessor:
    def __init__(self, feature_extractor=None, tokenizer=None):
        self.feature_extractor = feature_extractor or AVHubertFeatureExtractor()
        self.tokenizer = tokenizer

    def _normalize_target(self, text, bos="<s>", eos="</s>"):
        if not text.startswith(bos):
            text = bos + text
        if not text.endswith(eos):
            text = text + eos
        return text

    def __call__(self, audios=None, videos=None, text=None, extract_mouth=True):
        inputs = self.feature_extractor(
            audios=audios, videos=videos, extract_mouth=extract_mouth
        )
        if text is not None:
            if self.tokenizer is None:
                raise ValueError("a tokenizer is required to process targets")
            if isinstance(text, str):
                text = [text]
            ids = [
                self._encode(self._normalize_target(t)) for t in text
            ]
            max_u = max(len(x) for x in ids)
            pad_id = getattr(self.tokenizer, "pad_token_id", 0) or 0
            arr = np.full((len(ids), max_u), pad_id, np.int32)
            for i, x in enumerate(ids):
                arr[i, : len(x)] = x
            # teacher forcing: inputs drop last, labels drop first
            inputs["decoder_input_ids"] = arr[:, :-1]
            inputs["labels"] = arr[:, 1:]
        return inputs

    def _encode(self, text):
        tok = self.tokenizer
        if hasattr(tok, "encode"):
            return tok.encode(text, add_special_tokens=False)
        return tok.text_to_ids(text)

    def decode(self, ids, skip_special_tokens=True):
        tok = self.tokenizer
        if hasattr(tok, "decode"):
            return tok.decode(ids, skip_special_tokens=skip_special_tokens)
        return tok.ids_to_text(list(np.asarray(ids)))

    def batch_decode(self, batch_ids, skip_special_tokens=True):
        return [self.decode(ids, skip_special_tokens) for ids in batch_ids]
