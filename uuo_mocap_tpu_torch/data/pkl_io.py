"""Read and write the 4D-Humans/PHALP ``.pkl`` files without joblib.

4D-Humans' tracker writes its per-frame results with ``joblib.dump``, and
the JAX package reads them with ``joblib.load``.  joblib is not a
dependency of the port, so ``load_pkl`` reads joblib's format itself:

  * the file is a pickle, or a pickle compressed whole with zlib (joblib's
    ``compress=1..9``) or gzip;
  * each numpy array in it is pickled as a ``joblib.numpy_pickle.
    NumpyArrayWrapper`` (subclass, shape, order, dtype, alignment) whose
    raw bytes follow the wrapper's BUILD opcode in the stream: one byte
    giving a padding length, that many padding bytes, then the array's
    elements in its ``order``.

The unpickler maps the wrapper to a stub and, at each BUILD of one, reads
the array from the stream and puts it in the wrapper's place, as joblib's
``NumpyUnpickler`` does.  A plain pickle (no wrappers) reads as it is.

``dump_pkl`` writes a plain pickle, which ``joblib.load`` reads too.
Unpickling runs code named by the file: load only files you trust.
"""
from __future__ import annotations

import gzip
import io
import pickle
import zlib
from typing import Any

import numpy as np

_ZLIB_PREFIX = b"\x78"
_GZIP_PREFIX = b"\x1f\x8b"


class _ArrayWrapper:
    """Stands in for ``joblib.numpy_pickle.NumpyArrayWrapper``; BUILD fills
    its ``__dict__`` with the wrapper's fields."""

    def read(self, stream: io.BytesIO) -> np.ndarray:
        if self.dtype.hasobject:
            return pickle.load(stream)
        if getattr(self, "numpy_array_alignment_bytes", None) is not None:
            stream.read(stream.read(1)[0])  # padding length, then padding
        count = int(np.prod(self.shape, dtype=np.int64))
        nbytes = count * self.dtype.itemsize
        data = stream.read(nbytes)
        if len(data) != nbytes:
            raise ValueError(f"joblib pickle ends inside an array ({len(data)} of {nbytes} bytes)")
        array = np.frombuffer(data, dtype=self.dtype, count=count).copy()
        if self.order == "F":
            return array.reshape(self.shape[::-1]).transpose()
        return array.reshape(self.shape)


class _JoblibUnpickler(pickle._Unpickler):
    """The pure-Python unpickler (its opcode table can be extended) with
    joblib's array wrappers read from the stream."""

    dispatch = pickle._Unpickler.dispatch.copy()

    def __init__(self, stream: io.BytesIO):
        super().__init__(stream)
        self._stream = stream

    def find_class(self, module: str, name: str):
        if module == "joblib.numpy_pickle" and name == "NumpyArrayWrapper":
            return _ArrayWrapper
        if module.startswith("joblib"):
            raise pickle.UnpicklingError(
                f"{module}.{name}: only joblib's NumpyArrayWrapper format is supported")
        return super().find_class(module, name)

    def load_build(self):
        pickle._Unpickler.load_build(self)
        if isinstance(self.stack[-1], _ArrayWrapper):
            self.stack.append(self.stack.pop().read(self._stream))

    dispatch[pickle.BUILD[0]] = load_build


def _decompress(raw: bytes) -> bytes:
    if raw.startswith(_GZIP_PREFIX):
        return gzip.decompress(raw)
    if raw.startswith(_ZLIB_PREFIX):
        out, rest = [], raw
        while rest:  # concatenated zlib streams, as joblib's writer may produce
            d = zlib.decompressobj()
            out.append(d.decompress(rest))
            out.append(d.flush())
            rest = d.unused_data
        return b"".join(out)
    return raw  # a pickle starts with PROTO (0x80) or an opcode, never 0x78/0x1f


def load_pkl(path: str) -> Any:
    """The object in a pickle or joblib file (plain or zlib/gzip-compressed)."""
    with open(path, "rb") as f:
        raw = f.read()
    return _JoblibUnpickler(io.BytesIO(_decompress(raw))).load()


def dump_pkl(obj: Any, path: str) -> str:
    """Write ``obj`` as a plain pickle (readable by ``load_pkl`` and by
    ``joblib.load``)."""
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
    return path
