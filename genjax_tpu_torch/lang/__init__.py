from genjax_tpu_torch.lang import analysis
from genjax_tpu_torch.lang.interop import trace
from genjax_tpu_torch.lang.static import (
    AddressReuse,
    MissingAddress,
    StaticGenerativeFunction,
    StaticRequest,
    StaticTrace,
    gen,
)

__all__ = [
    "AddressReuse",
    "MissingAddress",
    "StaticGenerativeFunction",
    "StaticRequest",
    "StaticTrace",
    "gen",
    "trace",
]
