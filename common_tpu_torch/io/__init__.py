"""Serialization / checkpoint-resume and bulk text ingest (port of `common_tpu/io`)."""

from common_tpu_torch.io.checkpoint import (  # noqa: F401
    deserialize,
    load,
    save,
    serialize,
)
from common_tpu_torch.io.loader import load_csv_f32  # noqa: F401
