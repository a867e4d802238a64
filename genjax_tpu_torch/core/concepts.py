"""Core GFI type vocabulary: `Weight`, `Score`, `Arguments`.

Counterpart of `genjax_tpu/core/concepts.py`. The edit-request hierarchy
comes with edits.
"""

from genjax_tpu_torch.core.typing import FloatArray

Weight = FloatArray
"""A log density ratio arising from proper weighting."""

Score = FloatArray
"""A log density (or density estimate) of a trace's sample."""

Arguments = tuple
"""The type of argument tuples to generative functions."""
