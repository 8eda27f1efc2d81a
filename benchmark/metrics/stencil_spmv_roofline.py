"""The least time of one ``H x`` of a stencil operator (compulsory bytes:
read x, read the diagonal, write y, over the published 3.35 TB/s) as a
share of its measured time: the median over CUDA-graph replays of 50
``matvec`` calls that rotate over copies of the operator, each with its
own diagonal and its own x, so many that what the other copies read and
write between two uses of one outgrows four times the L2.  None for an
operator that is not a stencil on one grid."""

from benchmark import roofline


def probe(ctx):
    op = ctx.op
    if ctx.device == "cpu" or not hasattr(op, "grid_shape"):
        return None
    import torch

    m = op.shape[0]
    item = torch.empty(0, dtype=op.dtype).element_size()
    has_diag = getattr(op, "diag", None) is not None
    nbytes = roofline.spmv_bytes(m, item, has_diag)

    def copy(i):
        # Tag 5: this probe's own stream of draws from the run's seed.
        diag = op.diag.clone() if has_diag else None
        return (type(op)(op.weights, diag, op.grid_shape, op.offsets, op.graded),
                ctx.starts.draw(i, tag=5))

    turn = roofline.rotating_inputs(copy, nbytes)
    torch.cuda.synchronize()

    def call():
        a, x = next(turn)
        return a.matvec(x)

    ms, samples = roofline.graph_ms(call)
    return {"ms": ms, "samples": samples, "bytes": nbytes}


def read(rec):
    p = rec["probes"].get("stencil_spmv_roofline")
    if not p:
        return None
    return 100.0 * roofline.least_ms(p["bytes"]) / p["ms"]
