"""Set-up time of importing the program, in s: the program's
`setup.package_import` record (`genjax_tpu_torch/__init__.py`, first line
to last; torch's own import not counted where torch was imported first,
as `run.py` imports it). Nothing where the program keeps no such
record."""


def read(ctx):
    from genjax_tpu_torch.utils import profiling

    read_setup = getattr(profiling, "setup_spans", None)
    step = read_setup().get("setup.package_import") if read_setup is not None else None
    return None if step is None else step["seconds"]
