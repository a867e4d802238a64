from genjax_tpu_torch.lang.interop import trace
from genjax_tpu_torch.lang.static import (
    AddressReuse,
    MissingAddress,
    StaticGenerativeFunction,
    StaticTrace,
    gen,
)

__all__ = [
    "AddressReuse",
    "MissingAddress",
    "StaticGenerativeFunction",
    "StaticTrace",
    "gen",
    "trace",
]
