"""mpeg_tpu — GPU-native MPEG-1 Video / MP2 Audio / MPEG-PS framework.

A ground-up JAX/XLA re-design of the capabilities of
github.com/gen2brain/mpeg: serial bit work (demux, Huffman/VLC parse) runs
on host and emits dense arrays; the hot transforms (IDCT, motion
compensation, reconstruction, color conversion, MP2 synthesis filterbank)
run as whole-frame batched device dispatches, bit-exact against the
reference decoder.

High-level use mirrors the reference (mpeg.go:1-39):

    import mpeg_tpu as mpeg
    m = mpeg.MPEG(open("video.mpg", "rb"))
    frame = m.decode_video()       # Frame with .y/.cb/.cr planes
    samples = m.decode_audio()     # Samples with .interleaved float32

The lower-level Buffer, Demux, Video and Audio are public as well, for raw
elementary streams.
"""

from .buffer import Buffer, BUFFER_SIZE
from .demux import (
    Demux, Packet, InvalidHeaderError,
    PACKET_INVALID_TS, PACKET_PRIVATE, PACKET_VIDEO_1,
    PACKET_AUDIO_1, PACKET_AUDIO_2, PACKET_AUDIO_3, PACKET_AUDIO_4,
)
from .audio import Audio, AudioFormat, Samples, SAMPLES_PER_FRAME
from .video import Video, Frame
from .mpeg import MPEG, InvalidMpegError
from .config import Config

__all__ = [
    "MPEG", "InvalidMpegError", "Config",
    "Video", "Frame",
    "Buffer", "BUFFER_SIZE",
    "Demux", "Packet", "InvalidHeaderError",
    "PACKET_INVALID_TS", "PACKET_PRIVATE", "PACKET_VIDEO_1",
    "PACKET_AUDIO_1", "PACKET_AUDIO_2", "PACKET_AUDIO_3", "PACKET_AUDIO_4",
    "Audio", "AudioFormat", "Samples", "SAMPLES_PER_FRAME",
]

__version__ = "0.1.0"
