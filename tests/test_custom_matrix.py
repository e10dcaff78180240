"""Custom quantiser-matrix coverage (video.py:483-492;
/root/reference/video.go:303-316).

No reachable encoder emits the load_intra/load_non_intra sequence-header
bits, so tools/gen_custom_matrix.py splices deterministic non-default
matrices into the 260-frame ES fixture (the transformation is exactly
byte-aligned, see its docstring).  The decode golden is locked from the
python oracle; the native parser, the XLA backend and the blob batch
decoder must all match it bit-for-bit."""

import os
import sys

import numpy as np
import pytest

import mpeg_tpu as mpeg
from mpeg_tpu.utils import Fnv1a64

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from gen_custom_matrix import (  # noqa: E402
    CUSTOM_INTRA, CUSTOM_NON_INTRA, splice_custom_matrices,
)

GOLDEN = 0x82A9768F1F2B499B
FRAMES = 260


@pytest.fixture(scope="module")
def spliced(mpeg1video_path):
    return splice_custom_matrices(open(mpeg1video_path, "rb").read())


def _decode_all(data, backend, parser):
    buf = mpeg.Buffer(None)
    buf.write(data)
    buf.signal_end()
    v = mpeg.Video(buf, backend=backend, parser=parser)
    h = Fnv1a64()
    n = 0
    while (f := v.decode()) is not None:
        h.write(f.y.tobytes())
        h.write(f.cb.tobytes())
        h.write(f.cr.tobytes())
        n += 1
    return h.sum64(), n, v


def test_python_oracle_golden(spliced):
    h, n, v = _decode_all(spliced, "numpy", "python")
    assert n == FRAMES
    assert tuple(int(x) for x in np.ravel(v.intra_quant_matrix)) == \
        CUSTOM_INTRA
    assert tuple(int(x) for x in np.ravel(v.non_intra_quant_matrix)) == \
        CUSTOM_NON_INTRA
    assert h == GOLDEN, hex(h)
    # And the custom matrices actually change the output vs the default
    # golden (0xEA6D7FCB1340BA3F).
    assert h != 0xEA6D7FCB1340BA3F


def test_native_parser_golden(spliced):
    from mpeg_tpu import native
    if not native.available():
        pytest.skip("native parser unavailable")
    h, n, _ = _decode_all(spliced, "numpy", "native")
    assert n == FRAMES
    assert h == GOLDEN, hex(h)


def test_device_backend_golden(spliced):
    h, n, _ = _decode_all(spliced, "jax", "python")
    assert n == FRAMES
    assert h == GOLDEN, hex(h)


def test_blob_batch_golden(spliced):
    """Window-blob transport: the dequantised custom-matrix levels ride
    the quotient/escape record lanes unchanged."""
    from mpeg_tpu import native
    if not native.available():
        pytest.skip("native parser unavailable")
    from mpeg_tpu.parallel import BatchVideoDecoder
    h = Fnv1a64()
    n = 0
    dec = BatchVideoDecoder(spliced, window=16)
    while (got := dec.decode_window()):
        geom = dec.geom
        for fr in got:
            # flat[:frame_size] is the Y|Cb|Cr concatenation the
            # per-plane golden hashes (pad rows excluded).
            h.write(np.asarray(fr)[:geom.frame_size].tobytes())
            n += 1
    assert n == FRAMES
    assert h.sum64() == GOLDEN, hex(h.sum64())
