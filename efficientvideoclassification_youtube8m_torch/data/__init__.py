"""The data plane: TFRecord shards of YouTube-8M SequenceExamples, their
parsers (the native C++ one where it builds, data/native) and the
batching loaders. A copy of the JAX package's data/: the same bytes
written and the same batches read."""

from efficientvideoclassification_youtube8m_torch.data.loader import (
    FrameBatch,
    FrameDataLoader,
)
from efficientvideoclassification_youtube8m_torch.data.proto import iter_fields
from efficientvideoclassification_youtube8m_torch.data.tfrecord import (
    TFRecordReader,
    TFRecordWriter,
    crc32c,
    masked_crc32c,
)
from efficientvideoclassification_youtube8m_torch.data.yt8m import (
    FrameVideo,
    encode_frame_record,
    parse_frame_record,
    read_frame_file,
    write_synthetic_frame_shard,
)

__all__ = [
    "FrameBatch",
    "FrameDataLoader",
    "TFRecordReader",
    "TFRecordWriter",
    "crc32c",
    "masked_crc32c",
    "FrameVideo",
    "encode_frame_record",
    "iter_fields",
    "parse_frame_record",
    "read_frame_file",
    "write_synthetic_frame_shard",
]
