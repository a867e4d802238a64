"""Set-up time of K1, in s: the program's `setup.k1_load` record
(`ops/logsumexp.py::_kernel`, once a process: `nvcc`'s build where the
checkout holds no build of the kernel, then the library's load). Nothing
where the program keeps no such record or has not loaded K1."""


def read(ctx):
    from genjax_tpu_torch.utils import profiling

    read_setup = getattr(profiling, "setup_spans", None)
    step = read_setup().get("setup.k1_load") if read_setup is not None else None
    return None if step is None else step["seconds"]
