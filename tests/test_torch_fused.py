"""lightgbm_tpu_torch's grow megakernel twin and quantized grower against
lightgbm_tpu.

1. `fused_hist_scan_plain` (kernel B2's twin) against the JAX package's
   `fused_hist_scan`, run in interpret mode on the CPU: histograms and
   per-feature split records bitwise.
2. The whole quantized grower: the same numpy grad/hess, bins, meta and
   threefry key go to both packages' `grow`; records, leaf ids and leaf
   outputs bitwise, int8 and int16, stochastic rounding, with the leaf
   refit off and on.  (The frontier ramp is off here, to keep the JAX
   compile short; the end-to-end tests run it.)

The JAX side runs in a process compiled without FMA (see
`tests/test_torch_util.py`): XLA:CPU otherwise contracts a*b+c into one
rounding, which the port and its kernels do not do.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import fused as TF
from lightgbm_tpu_torch.ops import grower as TG
from lightgbm_tpu_torch.utils import prng

from .test_torch_util import (FUSED_KEYS, fused_args, fused_case,
                              run_jax_nofma)

FUSED_CASES = [
    # precision, F, n, nb, B, K, dead slots, split scalars
    ("int8", 6, 1024, 2, 27, 3, (1,), {}),
    ("int16", 5, 768, 3, 13, 4, (), dict(l1=0.5, l2=1.0, mds=0.3,
                                          min_data=20.0)),
]


@pytest.fixture(scope="module")
def fused_ref(tmp_path_factory):
    arrays, cases = {}, []
    for c, (prec, F, n, nb, B, K, dead, extra) in enumerate(FUSED_CASES):
        case, kw = fused_case(c, F, n, B, K, prec, dead, **extra)
        arrays.update({f"{c}_{k}": case[k] for k in FUSED_KEYS})
        cases.append(dict(precision=prec, nb=nb, B=B, split_kw=kw,
                          case=case))
    spec = {"cases": [{k: v for k, v in c.items() if k != "case"}
                      for c in cases]}
    out = run_jax_nofma("fused", arrays, spec,
                        tmp_path_factory.mktemp("fused"))
    return cases, out


@pytest.mark.parametrize("c", range(len(FUSED_CASES)))
def test_fused_twin_bitwise(fused_ref, c):
    cases, out = fused_ref
    cs = cases[c]
    hist, rec = TF.fused_hist_scan(
        *fused_args(cs["case"], cs["B"], cs["precision"]),
        split_kw=cs["split_kw"])
    np.testing.assert_array_equal(hist.numpy(), out[f"{c}_hist"])
    ref = out[f"{c}_rec"]
    assert rec.shape == ref.shape
    np.testing.assert_array_equal(rec.numpy().view(np.int32),
                                  ref.view(np.int32))
    assert (ref[..., 0] > 0).any()          # real splits, not sentinels


GROW_N, GROW_F, GROW_B, GROW_L = 3000, 10, 31, 15
GROW_RUNS = [(prec, refit) for prec in ("int8", "int16")
             for refit in (False, True)]


def _grow_inputs():
    rng = np.random.default_rng(5)
    F, n, B = GROW_F, GROW_N, GROW_B
    n_pad = 3072
    num_bin = rng.integers(8, B + 1, size=F).astype(np.int32)
    bins = np.zeros((F, n_pad), np.uint8)
    for f in range(F):
        bins[f, :n] = rng.integers(0, num_bin[f], size=n)
    grad, hess, mask = (np.zeros(n_pad, np.float32) for _ in range(3))
    grad[:n] = rng.normal(size=n)
    hess[:n] = np.abs(rng.normal(size=n)) * 0.3 + 0.05
    mask[:n] = 1.0
    meta = dict(num_bin=num_bin, missing_type=(np.arange(F) % 3)
                .astype(np.int32),
                default_bin=np.array([rng.integers(0, nb) for nb in num_bin],
                                     np.int32),
                monotone=np.zeros(F, np.int32),
                penalty=np.ones(F, np.float32))
    key = prng.split(prng.PRNGKey(11))[1]
    return dict(bins=bins, grad=grad, hess=hess, mask=mask,
                fmask=np.ones(F, np.float32), key=key), meta


def _grow_params(prec, refit):
    return dict(num_leaves=GROW_L, num_bins=GROW_B, precision=prec, l1=0.0,
                l2=0.0, max_delta_step=0.0, min_data_in_leaf=5.0,
                min_sum_hessian=1e-3, min_gain_to_split=0.0, max_depth=-1,
                split_batch=4, partition_impl="kernel", ramp=False,
                hist_impl="fused", quant_round="stochastic",
                quant_refit=refit)


@pytest.fixture(scope="module")
def grow_ref(tmp_path_factory):
    inputs, meta = _grow_inputs()
    arrays = dict(inputs, **{"meta_" + k: v for k, v in meta.items()})
    spec = {"meta_keys": list(meta),
            "runs": [{"params": dict(_grow_params(p, r), block_rows=512)}
                     for p, r in GROW_RUNS]}
    return run_jax_nofma("grow", arrays, spec,
                         tmp_path_factory.mktemp("grow"))


@pytest.mark.parametrize("c", range(len(GROW_RUNS)),
                         ids=[f"{p}-refit{int(r)}" for p, r in GROW_RUNS])
def test_grower_bitwise(grow_ref, c):
    inputs, meta = _grow_inputs()
    t = {k: torch.from_numpy(v) for k, v in inputs.items() if k != "key"}
    out = TG.grow(TG.GrowerParams(**_grow_params(*GROW_RUNS[c])),
                  t["bins"], t["grad"], t["hess"], t["mask"], t["fmask"],
                  {k: torch.from_numpy(v) for k, v in meta.items()},
                  inputs["key"])
    for name in ("records", "leaf_ids", "leaf_output"):
        ref = grow_ref[f"{c}_{name}"]
        got = out[name].numpy()
        assert got.shape == ref.shape, name
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32),
                                      err_msg=name)
    rec = out["records"].numpy()
    assert rec[:, TG.REC_DID_SPLIT].sum() == GROW_L - 1


def test_fused_supported():
    assert TF.fused_supported("int8") is None
    assert TF.fused_supported("int16") is None
    for prec in ("hilo", "bf16", "f32"):
        assert "int32" in TF.fused_supported(prec)


def test_fused_kernel_wrapper_refuses_cpu_tensors():
    args, kw = TF.probe_operands("int8", "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        TF.fused_hist_scan_kernel(*args, split_kw=kw)


def test_compare_catches_one_ulp():
    # the check the card probe runs: bitwise, so one ulp of one gain fails
    args, kw = TF.probe_operands("int16", "cpu")
    hist, rec = TF.fused_hist_scan(*args, split_kw=kw)
    TF.assert_fused_equal((hist, rec), (hist.clone(), rec.clone()))
    bad = rec.clone()
    bad.view(torch.int32)[1, 2, 0] += 1
    with pytest.raises(RuntimeError, match="records differ"):
        TF.assert_fused_equal((hist, bad), (hist, rec))
    with pytest.raises(RuntimeError, match="histograms differ"):
        TF.assert_fused_equal((hist + 1, rec), (hist, rec))
