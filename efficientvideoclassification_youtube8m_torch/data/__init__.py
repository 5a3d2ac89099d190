"""The data plane: TFRecord shards of YouTube-8M SequenceExamples, their
parsers (the native C++ one where it builds) and the batching loaders.
It does not import jax and is the JAX package's, re-exported, not copied."""

from efficientvideoclassification_youtube8m_tpu.data import (  # noqa: F401
    FrameBatch,
    FrameDataLoader,
    TFRecordReader,
    TFRecordWriter,
    encode_frame_record,
    write_synthetic_frame_shard,
)
from efficientvideoclassification_youtube8m_tpu.data.proto import (  # noqa: F401
    iter_fields,
)
