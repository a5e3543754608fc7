"""kkt_solves_per_iter (linear solve: ``ldlt_kernels.refine_solve``
through the step solver, ``step/solvers.py``): refined KKT solves per
iteration in the traced stretch, the sum of ``kkt_solves`` over its
``pgf.wait`` spans (each chunk's change of ``ldlt_kernels.REFINED
["solves"]``, counted on the device inside the graphs) over the
iterations of its answers.  A graphed chunk's masked bodies after the
terminal one solve too, so they count.  None where the program records
no such attribute."""

from harness.spans import program_spans


def read(ctx):
    spans = program_spans(ctx.stretch)
    if spans is None or ctx.stretch.iterations == 0:
        return None
    solves = [sp.attrs["kkt_solves"] for sp in spans if sp.name == "pgf.wait" and "kkt_solves" in sp.attrs]
    if not solves:
        return None
    return sum(solves) / ctx.stretch.iterations
