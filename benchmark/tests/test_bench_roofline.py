"""The byte counts behind the kernels' roofline shares."""

from benchmark import roofline


def test_spmv_bound_at_n160_fp32():
    # 12 B a point (read x, read diag, write y) over 3.35 TB/s.
    nbytes = roofline.spmv_bytes(160**3, 4)
    assert nbytes == 12 * 4_096_000
    assert round(roofline.least_ms(nbytes), 6) == 0.014672


def test_spmm_bound_at_n160_b4_fp32():
    # 36 B a point: four columns read and written, the diagonal once.
    nbytes = roofline.spmm_bytes(160**3, 4, 4)
    assert nbytes == 36 * 4_096_000
    assert round(roofline.least_ms(nbytes), 6) == 0.044017


def test_rotating_inputs_outgrow_the_l2():
    made = []
    # One call reads and writes 48 MiB (x, the diagonal, y at N=160^3 fp32,
    # about): 5 others between two uses of one, 240 MiB > 4 x 50 MiB.
    turn = roofline.rotating_inputs(lambda i: made.append(i) or i, 48 << 20)
    assert made == list(range(6))
    assert [next(turn) for _ in range(8)] == [0, 1, 2, 3, 4, 5, 0, 1]
    made.clear()
    roofline.rotating_inputs(lambda i: made.append(i), 1 << 30)
    assert made == [0, 1]  # an input past 4 x the L2 alternates with one other
