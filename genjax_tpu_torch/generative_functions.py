"""The languages, combinators and distributions in one namespace
(counterpart of `genjax_tpu.generative_functions`)."""

from genjax_tpu_torch.combinators import *  # noqa: F401,F403
from genjax_tpu_torch.combinators import __all__ as _cmb_all
from genjax_tpu_torch.distributions import *  # noqa: F401,F403
from genjax_tpu_torch.distributions import __all__ as _dist_all
from genjax_tpu_torch.lang import *  # noqa: F401,F403
from genjax_tpu_torch.lang import __all__ as _lang_all

__all__ = [*_cmb_all, *_dist_all, *_lang_all]  # noqa: PLE0604
