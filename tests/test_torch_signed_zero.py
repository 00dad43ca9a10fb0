"""Signed zeros in f32 MIN / MAX folds, on the CPU.

The port folds f32 MIN and MAX by IEEE 754-2019 ``minimum`` / ``maximum``
on every path: -0.0 lies below +0.0, whatever the order of the entries (the
ops' MIN / MAX, ``utils.segments.segment_fold``, the kernels' ``op_min`` /
``op_max`` and their plain versions).  Each public fold path, the plain
versions of kernels 1, 5, 7 and 9 and ``segment_fold``'s three paths fold
products or values that tie at +0.0 and -0.0, in both entry orders; MIN must
give -0.0 and MAX +0.0 in both.  Where spla_tpu follows the same rule (its
scatters and reductions) the port matches it bit for bit; where it does not
(its segmented scans: ``mxm``, ``dist_mxm`` and ``segment_fold``'s generic
path) a ``test_pin_*`` states both answers.

Every comparison is of bit patterns (``view(int32)``): an equality of
values would take -0.0 for +0.0.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import spla_tpu.formats as JF
import spla_tpu.op as JOP
import spla_tpu.ops as JOPS
import spla_tpu.parallel as JP
import spla_tpu.utils.segments as JSEG
from spla_tpu.containers import DenseVec as JDenseVec

import spla_tpu_torch.ops as OPS
import spla_tpu_torch.parallel as P
from spla_tpu_torch import formats as F, op as OP
from spla_tpu_torch.interop import from_spla_tpu, to_numpy
from spla_tpu_torch.kernels import mxmt as K45, spgemm as K9, spmv as K1, staged as K7
from spla_tpu_torch.utils import segments as SEG

POS, NEG = np.float32(0.0), np.float32(-0.0)
ORDERS = {"+0,-0": (POS, NEG), "-0,+0": (NEG, POS)}
INIT = {"MIN": np.float32(np.inf), "MAX": np.float32(-np.inf)}
RULE = {"MIN": NEG, "MAX": POS}  # the zero a tie of +0.0 and -0.0 folds to


def bits(a) -> np.ndarray:
    """The int32 bit patterns of f32 values (a tensor, a container's values or an array)."""
    return np.ascontiguousarray(np.asarray(to_numpy(a), np.float32)).view(np.int32)


def same_bits(got, want):
    np.testing.assert_array_equal(bits(got), bits(want))


def csr(shape, entries, fill=0.0):
    """A scipy CSR of ``{(i, j): value}``, explicit zeros and their signs kept."""
    keys = sorted(entries)
    rows = np.array([i for i, _ in keys], np.int32)
    cols = np.array([j for _, j in keys], np.int32)
    vals = np.array([entries[k] for k in keys], np.float32)
    indptr = np.zeros(shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=shape[0]), out=indptr[1:])
    return sp.csr_matrix((vals, cols, indptr), shape=shape)


def both(a, fill=0.0):
    """spla_tpu's CSR of ``a`` and the port's copy of it."""
    j = JF.csr_from_scipy(a, fill=np.float32(fill))
    return j, from_spla_tpu(j, "cpu")


def dense(x, fill):
    j = JDenseVec(jnp.asarray(np.asarray(x, np.float32)), jnp.float32(fill))
    return j, from_spla_tpu(j, "cpu")


def ops(add):
    return getattr(JOP, f"{add}_FLOAT"), getattr(OP, f"{add}_FLOAT")


# Each case returns (port values, spla_tpu values or None, the tied slots), the
# tie being (z0, z1) in that entry order.  A = [[1, 1, 0, 0], [0, 0, 2, 0], 0, [0, 1, 0, 1]]
# with x = [z0, z1, 3, 5]: row 0 ties, row 1 is 6, row 2 is empty and row 3 folds z1 and 5.

def _spmv_operands(z0, z1, add, x_fill):
    A = csr((4, 4), {(0, 0): 1, (0, 1): 1, (1, 2): 2, (3, 1): 1, (3, 3): 1})
    (jA, tA), (jx, tx), (jm, tm) = both(A, INIT[add]), dense([z0, z1, 3, 5], x_fill), dense([1] * 4, 0)
    return (jA, jx, jm), (tA, tx, tm)


def case_mxv_masked(z0, z1, add):
    (jA, jx, jm), (tA, tx, tm) = _spmv_operands(z0, z1, add, 0.0)
    (jo, to), init = ops(add), INIT[add]
    return (OPS.mxv_masked(tm, tA, tx, OP.MULT_FLOAT, to, OP.ALWAYS_FLOAT, init).values,
            JOPS.mxv_masked(jm, jA, jx, JOP.MULT_FLOAT, jo, JOP.ALWAYS_FLOAT, init).values, [0])


def case_vxm_masked_dense(z0, z1, add):
    # x's fill is no zero, so both zeros are stored; A serves as M_t, whose row 0 ties
    (jA, jx, jm), (tA, tx, tm) = _spmv_operands(z0, z1, add, 7.0)
    (jo, to), init = ops(add), INIT[add]
    return (OPS.vxm_masked_dense(tm, tx, tA, OP.MULT_FLOAT, to, OP.ALWAYS_FLOAT, init).values,
            JOPS.vxm_masked_dense(jm, jx, jA, JOP.MULT_FLOAT, jo, JOP.ALWAYS_FLOAT, init).values, [0])


def case_vxm_masked(z0, z1, add):
    (jA, jx, jm), (tA, tx, tm) = _spmv_operands(z0, z1, add, 7.0)
    (jo, to), init = ops(add), INIT[add]
    jv, tv = JF.dense_to_sparse_vec(jx), F.dense_to_sparse_vec(tx)
    return (OPS.vxm_masked(tm, tv, tA, OP.MULT_FLOAT, to, OP.ALWAYS_FLOAT, init).values,
            JOPS.vxm_masked(jm, jv, jA, JOP.MULT_FLOAT, jo, JOP.ALWAYS_FLOAT, init).values, [0])


def _tie_matrix(z0, z1, add, by_column=False):
    """[[z0, z1, .], [., -3 or 3, .], ...]: the tie in row 0 (column 0 when
    ``by_column``), a value below (MIN: above) the zeros elsewhere would hide it."""
    far = 3.0 if add == "MIN" else -3.0
    entries = {(0, 0): z0, (1, 0): z1, (1, 1): far} if by_column else {(0, 0): z0, (0, 1): z1, (1, 1): far}
    return both(csr((3, 3), entries))


def case_m_reduce(z0, z1, add):
    (jo, to), init = ops(add), INIT[add]
    jB, tB = both(csr((3, 3), {(0, 0): z0, (0, 1): z1}))
    return (OPS.m_reduce(init, tB, to).value.reshape(1), np.asarray(JOPS.m_reduce(init, jB, jo).value).reshape(1),
            [0])


def case_m_reduce_by_row(z0, z1, add):
    (jo, to), init = ops(add), INIT[add]
    jB, tB = _tie_matrix(z0, z1, add)
    return OPS.m_reduce_by_row(tB, to, init).values, JOPS.m_reduce_by_row(jB, jo, init).values, [0]


def case_m_reduce_by_column(z0, z1, add):
    (jo, to), init = ops(add), INIT[add]
    jB, tB = _tie_matrix(z0, z1, add, by_column=True)
    return OPS.m_reduce_by_column(tB, to, init).values, JOPS.m_reduce_by_column(jB, jo, init).values, [0]


def case_v_reduce(z0, z1, add):
    (jo, to), init = ops(add), INIT[add]
    jv, tv = dense([z0, z1, z0], 7.0)
    return (OPS.v_reduce(init, tv, to).value.reshape(1), np.asarray(JOPS.v_reduce(init, jv, jo).value).reshape(1),
            [0])


def _mxmT_operands(z0, z1, add):
    """mask [[1, 1], [1, .]], A = [[1, 1], [2, .]], B = [[z0, z1], [z1, 4]]:
    C[0, 0] = (z0, z1) tie, C[0, 1] = (z1, 4), C[1, 0] = 2 z0."""
    mask = both(csr((2, 2), {(0, 0): 1, (0, 1): 1, (1, 0): 1}))
    A = both(csr((2, 2), {(0, 0): 1, (0, 1): 1, (1, 0): 2}))
    B = both(csr((2, 2), {(0, 0): z0, (0, 1): z1, (1, 0): z1, (1, 1): 4}))
    return mask, A, B


def case_mxmT_masked(z0, z1, add):
    (jo, to), init = ops(add), INIT[add]
    (jm, tm), (jA, tA), (jB, tB) = _mxmT_operands(z0, z1, add)
    got = OPS.mxmT_masked(tm, tA, tB, OP.MULT_FLOAT, to, OP.ALWAYS_FLOAT, init)
    want = JOPS.mxmT_masked(jm, jA, jB, JOP.MULT_FLOAT, jo, JOP.ALWAYS_FLOAT, init)
    return to_numpy(got.values)[: int(got.nnz)], np.asarray(want.values)[: int(want.nnz)], [0]


def _mxm_operands(z0, z1):
    """A = [[1, 1], [1, .]], B = [[z0, 2], [z1, .]]: C[0, 0] = (z0, z1) tie,
    C[0, 1] = 2, C[1, 0] = z0, C[1, 1] = 2."""
    A = both(csr((2, 2), {(0, 0): 1, (0, 1): 1, (1, 0): 1}))
    B = both(csr((2, 2), {(0, 0): z0, (0, 1): 2, (1, 0): z1}))
    return A, B


def case_mxm(z0, z1, add):
    (jo, to), init = ops(add), INIT[add]
    (jA, tA), (jB, tB) = _mxm_operands(z0, z1)
    got = OPS.mxm(tA, tB, OP.MULT_FLOAT, to, init)
    want = JOPS.mxm(jA, jB, JOP.MULT_FLOAT, jo, init)
    return to_numpy(got.values)[: int(got.nnz)], np.asarray(want.values)[: int(want.nnz)], [0]


def _segments(z0, z1, num_segments):
    """Segment 0 holds z0, z1, z0 and segment 1 holds 5, -5 (invalid when
    there is one segment)."""
    vals = np.array([z0, z1, z0, 5.0, -5.0], np.float32)
    seg = np.array([0, 0, 0, 1, 1], np.int32)
    return vals, seg, np.arange(5) < (3 if num_segments == 1 else 5)


class _Unscattered:
    """An op without a scatter kind: segment_fold's generic (scan) path."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, a, b):
        return self.fn(a, b)


def _segment_case(z0, z1, add, num_segments, scan):
    (jo, to), init = ops(add), INIT[add]
    vals, seg, valid = _segments(z0, z1, num_segments)
    if scan:
        jo, to = _Unscattered(getattr(jo, "fn", jo)), _Unscattered(to)
    got = SEG.segment_fold(torch.from_numpy(vals), torch.from_numpy(seg), torch.from_numpy(valid),
                           num_segments, to, init)[0]
    want = JSEG.segment_fold(jnp.asarray(vals), jnp.asarray(seg), jnp.asarray(valid), num_segments, jo, init)[0]
    return got, want, [0]


def case_segment_fold_one(z0, z1, add):
    return _segment_case(z0, z1, add, 1, scan=False)


def case_segment_fold_scatter(z0, z1, add):
    return _segment_case(z0, z1, add, 2, scan=False)


def case_segment_fold_scan(z0, z1, add):
    return _segment_case(z0, z1, add, 2, scan=True)


# the plain versions of kernels 1, 5, 7 and 9, against the public op that spla_tpu runs for
# the same request (kernel 9's: its mxm, a scan: compared with the rule only)

def case_kernel1_plain(z0, z1, add):
    _, (tA, tx, _) = _spmv_operands(z0, z1, add, 0.0)
    (_, to), init = ops(add), INIT[add]
    got = K1.spmv_pull_plain(tA, tx.values, OP.MULT_FLOAT, to, init)[0]
    swapped = K1.spmv_pull_plain(tA, tx.values, OP.MULT_FLOAT, to, init, swap=True)[0]
    same_bits(swapped, got)
    return got, case_mxv_masked(z0, z1, add)[1], [0]


def case_kernel7_plain(z0, z1, add):
    _, (tA, tx, _) = _spmv_operands(z0, z1, add, 0.0)
    (_, to), init = ops(add), INIT[add]
    got = K7.spmv_pull_staged_plain(tA, tx.values, OP.MULT_FLOAT, to, init, stage=2)[0]  # a piece an entry
    same_bits(K7.spmv_pull_staged_plain(tA, tx.values, OP.MULT_FLOAT, to, init)[0], got)
    return got, case_mxv_masked(z0, z1, add)[1], [0]


def case_kernel5_plain(z0, z1, add):
    (_, to), init = ops(add), INIT[add]
    (_, tm), (_, tA), (_, tB) = _mxmT_operands(z0, z1, add)
    got, has = K45.mxmt_masked_plain(tm, tA, tB, OP.MULT_FLOAT, to, init)
    return got[has], case_mxmT_masked(z0, z1, add)[1], [0]


def case_kernel9_plain(z0, z1, add):
    (_, to), init = ops(add), INIT[add]
    (_, tA), (_, tB) = _mxm_operands(z0, z1)
    got = K9.mxm_plain(tA, tB, OP.MULT_FLOAT, to, init)
    return to_numpy(got.values)[: int(got.nnz)], None, [0]


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}
# the paths where spla_tpu folds by scans, not by the rule: pinned below
SCANNED = ("mxm", "segment_fold_scan", "kernel9_plain")


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("add", ["MIN", "MAX"])
@pytest.mark.parametrize("path", list(CASES))
def test_f32_fold_of_signed_zeros_follows_the_rule(path, add, order):
    """The tie folds to -0.0 under MIN and +0.0 under MAX in either entry
    order; every other slot, and on the paths where spla_tpu follows the
    rule every slot, equals spla_tpu bit for bit."""
    got, want, tied = CASES[path](*ORDERS[order], add)
    got = bits(got)
    assert (got[tied] == bits(np.full(len(tied), RULE[add]))).all(), (path, add, order, got)
    if want is not None:
        want = bits(want)
        if path in SCANNED:  # equal values; the zeros' signs are pinned below
            np.testing.assert_array_equal(got.view(np.float32), want.view(np.float32))
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("path", ["mxm", "segment_fold_scan"])
def test_pin_spla_tpu_scans_lose_the_sign_of_zero(path, order):
    """spla_tpu's segmented scans (``lax.associative_scan``: ``mxm``'s
    ``_run_fold_compact``, ``segment_fold``'s generic path) give +0.0
    wherever their fold is a zero: a MIN tie of +0.0 and -0.0, where the
    rule (and spla_tpu's scatters) give -0.0, and in ``mxm`` a lone -0.0
    product (C[1, 0] = z0).  The port keeps the rule and the product's
    sign; every value is the same."""
    for add in ("MIN", "MAX"):
        got, want, tied = CASES[path](*ORDERS[order], add)
        got, want = bits(got), bits(want)
        assert (want[want.view(np.float32) == 0] == 0).all(), want
        assert got[tied].tolist() == bits(np.full(len(tied), RULE[add])).tolist()
        np.testing.assert_array_equal(got.view(np.float32), want.view(np.float32))
        if path == "mxm":
            assert got[2] == bits(np.array([ORDERS[order][0]]))[0]


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo world of one rank in this process, and spla_tpu's mesh of one device."""
    import torch.distributed as dist

    mesh = P.make_device_mesh(device="cpu")
    yield mesh, JP.make_device_mesh(1)
    dist.destroy_process_group()


def test_dist_sssp_over_signed_zero_weights(world_of_one):
    """dist_sssp (its MIN folds through kernel 1's plain version and the
    op's MIN) at a world of one, over weights of +0.0 and -0.0 in both
    orders of a vertex's in-edges: the bits of spla_tpu's dist_sssp."""
    mesh, jmesh = world_of_one
    for z0, z1 in ORDERS.values():
        # vertex 2 is reached from 0 and 1 by edges z0 and z1; 1 from 0 by z1; 3 from 2 by 1
        a = csr((4, 4), {(1, 0): z1, (2, 0): z0, (2, 1): z1, (3, 2): 1.0})  # A^T: row i holds i's in-edges
        got = P.dist_sssp(mesh, P.shard_csr_by_rows(F.csr_from_scipy(a, device="cpu"), 1, mesh), 0)
        want = JP.dist_sssp(jmesh, JP.shard_csr_by_rows(JF.csr_from_scipy(a), 1, jmesh), 0)
        same_bits(got, np.asarray(want).ravel()[:4])
        assert bits(got).tolist() == bits(np.array([0, 0, 0, 1], np.float32)).tolist()


def test_pin_dist_mxm_folds_min_ties_to_positive_zero(world_of_one):
    """spla_tpu's dist_mxm folds each (i, j)'s products by a segmented scan
    too: MIN of +0.0 and -0.0 gives +0.0 there, -0.0 in the port."""
    mesh, jmesh = world_of_one
    for z0, z1 in ORDERS.values():
        (ja, ta), (jb, tb) = _mxm_operands(z0, z1)
        got = P.dist_mxm(mesh, P.shard_csr_by_rows(ta, 1, mesh), P.shard_csr_by_rows(tb, 1, mesh),
                         OP.MULT_FLOAT, OP.MIN_FLOAT, np.inf)
        want = JP.dist_mxm(jmesh, JP.shard_csr_by_rows(ja, 1, jmesh), JP.shard_csr_by_rows(jb, 1, jmesh),
                           JOP.MULT_FLOAT, JOP.MIN_FLOAT, np.inf)
        assert bits(to_numpy(got.values)[:1]).tolist() == bits(np.array([NEG])).tolist()
        assert bits(np.asarray(want.values).ravel()[:1]).tolist() == bits(np.array([POS])).tolist()
