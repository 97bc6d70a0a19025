"""Serialization / checkpoint-resume (port of `common_tpu/io`)."""

from common_tpu_torch.io.checkpoint import (  # noqa: F401
    deserialize,
    load,
    save,
    serialize,
)
