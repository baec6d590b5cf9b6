"""The port's recurrent families (zamba2's Mamba2 hybrid, xLSTM) against
the JAX reference at float32 on carried weights: the SSD scan, the
depthwise conv, the mLSTM parallel/decode/final-state forms, the sLSTM
loop, and both archs end to end.  Tolerances: tests/torch_model_parity.py
and each test below."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import ssm as SS
from repro.models import xlstm as XL
from repro.shardings import Sharding
from repro_torch.errors import ConfigError
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSS
from repro_torch.models import xlstm as TXL
from repro_torch.shardings import Sharding as TSharding
from torch_model_parity import carried, check_model, max_abs
from torch_model_parity import torch_one_thread  # noqa: F401 (autouse)

LAYER_TOL = 1e-5
SCAN_TOL = 1e-4          # sums over 64 steps of exp-weighted states


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_ssd_chunked_over_chunks_from_a_state():
    """S = 64 in chunks of 16 (nc = 4), from a nonzero h0."""
    rng = np.random.default_rng(6)
    B, S, H, P, N = 2, 64, 3, 8, 5
    xin, Bm, Cm = _rand(rng, B, S, H, P), _rand(rng, B, S, N), \
        _rand(rng, B, S, N)
    la = -np.abs(_rand(rng, B, S, H)) * 0.3
    h0 = _rand(rng, B, H, N, P)
    ry, rh = SS.ssd_chunked(*map(jnp.asarray, (xin, la, Bm, Cm)), chunk=16,
                            h0=jnp.asarray(h0))
    ty, th = TSS.ssd_chunked(*_t(xin, la, Bm, Cm), chunk=16,
                             h0=torch.from_numpy(h0))
    assert max_abs(ry, ty) <= SCAN_TOL and max_abs(rh, th) <= SCAN_TOL
    try:
        TSS.ssd_chunked(*_t(xin[:, :40], la[:, :40], Bm[:, :40],
                            Cm[:, :40]), chunk=16)
    except ConfigError:
        pass
    else:
        raise AssertionError("S % chunk != 0 must raise ConfigError")


def test_depthwise_conv_with_and_without_state():
    rng = np.random.default_rng(7)
    x, w, st = _rand(rng, 2, 9, 6), _rand(rng, 4, 6), _rand(rng, 2, 3, 6)
    for state in (None, st):
        ry, rs = SS.depthwise_conv(jnp.asarray(x), jnp.asarray(w),
                                   None if state is None
                                   else jnp.asarray(state))
        ty, ts = TSS.depthwise_conv(torch.from_numpy(x), torch.from_numpy(w),
                                    None if state is None
                                    else torch.from_numpy(state))
        assert max_abs(ry, ty) <= LAYER_TOL and max_abs(rs, ts) == 0.0


def test_mlstm_parallel_decode_and_final_state():
    sc, tc, p, tp = carried("xlstm-125m")
    cell = jax.tree.map(lambda a: a[0, 0], p["layers"]["mlstm"]["cell"])
    tcell = {k: v[0, 0] for k, v in tp["layers"]["mlstm"]["cell"].items()}
    x = _rand(np.random.default_rng(8), 2, 16, sc.d_model)
    shd, tsd = Sharding(None, sc), TSharding(None, tc)
    assert max_abs(XL.mlstm_parallel(cell, jnp.asarray(x), sc, shd),
                   TXL.mlstm_parallel(tcell, torch.from_numpy(x), tc, tsd)
                   ) <= SCAN_TOL
    rst = XL.mlstm_final_state(cell, jnp.asarray(x), sc)
    tst = TXL.mlstm_final_state(tcell, torch.from_numpy(x), tc)
    for k in ("C", "n", "m"):
        assert max_abs(rst[k], tst[k]) <= SCAN_TOL, k
    x1 = x[:, :1]
    ro, rn = XL.mlstm_decode(cell, jnp.asarray(x1), sc, rst)
    to, tn = TXL.mlstm_decode(tcell, torch.from_numpy(x1), tc, tst)
    assert max_abs(ro, to) <= SCAN_TOL
    for k in ("C", "n", "m"):
        assert max_abs(rn[k], tn[k]) <= SCAN_TOL, k


def test_slstm_block():
    sc, tc, p, tp = carried("xlstm-125m")
    cell = jax.tree.map(lambda a: a[0], p["layers"]["slstm"]["cell"])
    tcell = {k: v[0] for k, v in tp["layers"]["slstm"]["cell"].items()}
    x = _rand(np.random.default_rng(9), 2, 24, sc.d_model)
    ro, rs = XL.slstm_block(cell, jnp.asarray(x), sc, Sharding(None, sc))
    to, ts = TXL.slstm_block(tcell, torch.from_numpy(x), tc,
                             TSharding(None, tc))
    assert max_abs(ro, to) <= SCAN_TOL
    for r, t in zip(rs, ts):
        assert max_abs(r, t) <= SCAN_TOL


def test_mlstm_init_draws_w_out_equal_to_wq():
    """The reference draws the mLSTM's w_out from wq's key, so the two are
    equal at init (src/repro/models/xlstm.py:101,108); the port copies that
    on purpose."""
    sc, tc, p, _ = carried("xlstm-125m", fp32=False)
    cell = p["layers"]["mlstm"]["cell"]
    assert bool(jnp.array_equal(cell["wq"], cell["w_out"]))
    tp = TM.init_params(tc, torch.Generator().manual_seed(0), shards=4,
                        device="cpu")
    tcell = tp["layers"]["mlstm"]["cell"]
    assert torch.equal(tcell["wq"], tcell["w_out"])
    assert tcell["w_out"].data_ptr() != tcell["wq"].data_ptr()


def test_model_matches_the_reference_zamba2():
    check_model("zamba2-2.7b")


def test_model_matches_the_reference_xlstm():
    check_model("xlstm-125m")
