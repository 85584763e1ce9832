"""Host seconds of set-up spent building the engine's grid statics: the
program's ``engine.statics`` spans (the grid, ``build_grid_statics``,
the lattice offsets and face lattice) between the start of the process
(``ctx.t_start``) and the start of the measured window."""

from benchmark import spans


def read(run, ctx):
    got = spans.between("engine.statics", round(ctx.t_start * 1e9),
                        spans.window_ns(run, ctx)[0])
    if not got:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in got) * 1e-9
