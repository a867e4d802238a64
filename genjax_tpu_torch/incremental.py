"""Change tangents (counterpart of `genjax_tpu.incremental`). JAX's
`incremental` transform comes with the incremental edits."""

from genjax_tpu_torch.core.diff import ChangeTangent, Diff, NoChange, UnknownChange

__all__ = ["ChangeTangent", "Diff", "NoChange", "UnknownChange"]
