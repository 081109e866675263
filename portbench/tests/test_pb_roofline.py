"""The frozen MSDA counts reproduce the bounds the program's kernel table
records: K1 at the captured flagship shape (B=4, Q=11,403 encoder queries,
G=1, bf16 value), K3 at the 5-scale encoder (B=4, Q=45,570, S=89,250, G=8)."""

from portbench.roofline.msda import backward_work, forward_work, least_seconds

FLAGSHIP_S = 100 * 168 + 50 * 84 + 25 * 42 + 13 * 21


def test_k1_flagship():
    moved, ops = forward_work([4, FLAGSHIP_S, 256], [4, 11403, 1, 4, 4, 2], [4, 11403, 8, 4, 4], 2)
    seconds, by = least_seconds(moved, ops)
    assert by == "bytes" and round(seconds * 1e3, 4) == 0.0293


def test_k3_five_scale():
    moved, ops = backward_work([4, 89250, 256], [4, 45570, 8, 4, 4, 2], [4, 45570, 8, 4, 4], 2)
    seconds, by = least_seconds(moved, ops)
    assert by == "bytes" and round(seconds * 1e3, 4) == 0.3041
