"""The share of the categorical's rows that K4 drew or scored, in %: the
program's counter `k4_rows` of `distributions.library.categorical_stats`
over its rows `drawn` and `scored`, over every call the run made. Nothing
where the program keeps no such counter, or drew and scored no row."""


def read(ctx):
    from genjax_tpu_torch.distributions import library

    counted = getattr(library, "categorical_stats", None)
    if not counted or "k4_rows" not in counted:
        return None
    rows = counted.get("drawn", 0) + counted.get("scored", 0)
    if not rows:
        return None
    return 100.0 * counted["k4_rows"] / rows
