"""Interactive rendering: register treescope as the notebook display
hook (counterpart of `genjax_tpu/utils/pretty.py`)."""


def pretty() -> None:
    """Enable treescope rendering for interactive sessions and notebooks;
    warns and does nothing where treescope is not installed."""
    try:
        import treescope

        treescope.register_as_default()
        treescope.active_autovisualizer.set_globally(treescope.ArrayAutovisualizer())
    except ImportError:
        import warnings

        warnings.warn("treescope is not installed; pretty() is a no-op.")
