"""Minimal ONNX weight extraction (no onnx package required).

A copy of ``reazonspeech_tpu/convert/onnx_reader.py`` with the same
behaviour; the protobuf field reader is the port's ``core/tokenizer.py``.

The reference's k2 models ship as sherpa ONNX graphs
(pkg/k2-asr/src/huggingface.py:40-59: encoder/decoder/joiner × fp32/int8).
This reads ModelProto → GraphProto → initializer TensorProtos straight from
the protobuf wire format and returns {name: ndarray}, which
onnx_zipformer-style mappers consume. int8 quantized initializers
(DynamicQuantizeLinear exports) come back as int8 arrays alongside their
scale tensors.
"""

import struct

import numpy as np

from ..core.tokenizer import _iter_fields

__all__ = ["read_onnx_initializers"]

# TensorProto.DataType
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    10: np.float16,
    11: np.float64,
}


def _parse_tensor(buf):
    dims, dtype, name = [], 1, ""
    raw = None
    float_data, int32_data, int64_data = [], [], []
    for fnum, wt, val in _iter_fields(buf):
        if fnum == 1 and wt == 0:
            dims.append(val)
        elif fnum == 2 and wt == 0:
            dtype = val
        elif fnum == 8 and wt == 2:
            name = val.decode("utf-8", "replace")
        elif fnum == 9 and wt == 2:
            raw = val
        elif fnum == 4 and wt == 5:  # float_data
            float_data.append(struct.unpack("<f", val)[0])
        elif fnum == 4 and wt == 2:  # packed float_data
            float_data.extend(np.frombuffer(val, "<f4").tolist())
        elif fnum == 5 and wt == 2:  # packed int32_data
            int32_data.extend(np.frombuffer(val, "<i4").tolist())
        elif fnum == 7 and wt == 2:  # packed int64_data
            int64_data.extend(np.frombuffer(val, "<i8").tolist())
    np_dtype = _DTYPES.get(dtype)
    if np_dtype is None:
        return name, None
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype)
    elif float_data:
        arr = np.asarray(float_data, np_dtype)
    elif int64_data:
        arr = np.asarray(int64_data, np_dtype)
    elif int32_data:
        arr = np.asarray(int32_data, np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


def read_onnx_initializers(path):
    """Return {initializer_name: ndarray} from an .onnx file."""
    with open(path, "rb") as f:
        data = f.read()
    out = {}
    for fnum, wt, val in _iter_fields(data):
        if fnum == 7 and wt == 2:  # ModelProto.graph
            for gfnum, gwt, gval in _iter_fields(val):
                if gfnum == 5 and gwt == 2:  # GraphProto.initializer
                    name, arr = _parse_tensor(gval)
                    if arr is not None:
                        out[name] = arr
    return out
