from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.gather import take_rows
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace
from genjax_tpu_torch.core.pytree import Pytree

__all__ = ["ChoiceMap", "GenerativeFunction", "Pytree", "Selection", "Trace", "take_rows"]
