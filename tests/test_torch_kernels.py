"""The PyTorch port's batch kernels against the JAX reference, on the CPU.

One seeded numpy draw (kubernetes_tpu_torch.testing.kernel_inputs) feeds
the JAX package's functions (as jnp arrays) and the port's (through the
carry-across functions state_from_jax_numpy / features_from_jax_numpy /
carry_from_jax_numpy). On CPU tensors the port's wrappers run their plain
PyTorch versions, so this holds the plain versions equal to JAX; the CUDA
kernels are held equal to the plain versions on the card by chip_smoke.py.
Every comparison is exact: all quantities are integers or booleans."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kubernetes_tpu.ops.device_state import DeviceNodeState as JaxState
from kubernetes_tpu.ops.features import BatchFeatures as JaxFeatures
from kubernetes_tpu.ops.kernel import ScanCarry as JaxCarry
from kubernetes_tpu.ops.kernel import _resource_eval as jax_resource_eval
from kubernetes_tpu.ops.kernel import _static_masks as jax_static_masks
from kubernetes_tpu.ops.kernel import schedule_batch as jax_schedule_batch
from kubernetes_tpu_torch.ops import kernel as K
from kubernetes_tpu_torch.ops.device_state import state_from_jax_numpy
from kubernetes_tpu_torch.ops.features import features_from_jax_numpy
from kubernetes_tpu_torch.ops.kernel import carry_from_jax_numpy
from kubernetes_tpu_torch.testing.kernel_inputs import random_inputs

VMAX = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The inputs are small: one intra-op thread is enough, and it keeps
    this module from crowding the other test workers' CPUs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _both(seed, np_cap=256, num_nodes=200, **kw):
    """(JAX state, JAX features, port state, port features) from one draw."""
    s, f = random_inputs(seed, np_cap, num_nodes, vmax=VMAX, **kw)
    js = JaxState(*[jnp.asarray(a) for a in s])
    jf = JaxFeatures(*[jnp.asarray(a) for a in f])
    ts = state_from_jax_numpy([np.asarray(a) for a in js])
    tf = features_from_jax_numpy([np.asarray(a) for a in jf])
    return js, jf, ts, tf


def _same(jax_arrays, torch_arrays, what):
    for i, (a, b) in enumerate(zip(jax_arrays, torch_arrays)):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} lane {i}")


CASES = {
    "default": dict(),
    "start-past-rows": dict(start=199),
    "truncation-off": dict(to_find=200),
    "zero-request": dict(zero_request=True),
    "all-infeasible": dict(infeasible=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_static_masks(case):
    js, jf, ts, tf = _both(11, **CASES[case])
    want = jax_static_masks(js, jf)
    got = K.static_masks(ts, tf)
    _same(want, got[:6], "static_masks")
    static_ok = (js.valid & want[0] & want[2] & want[3] & want[4] & want[5] & jf.extra_ok)
    _same([static_ok], [got.static_ok], "static_ok")


@pytest.mark.parametrize("fit_strategy", [0, 1], ids=["least", "most"])
@pytest.mark.parametrize("case", ["default", "zero-request", "all-infeasible"])
def test_resource_eval(case, fit_strategy):
    js, jf, ts, tf = _both(12, **CASES[case])
    want = jax_resource_eval(jf, fit_strategy, js.alloc_r, js.alloc_pods, js.req_r,
                             js.nonzero, js.pod_count)
    got = K.resource_eval(tf, fit_strategy, ts.alloc_r, ts.alloc_pods, ts.req_r,
                          ts.nonzero, ts.pod_count)
    _same(want, got, "resource_eval")


def _chain(js, jf, ts, tf, batch_pad, fit_strategy, n_active):
    """Fresh batch, then a second one chained through carry_in; both
    packages. Returns [(jax results, jax carry, port results, port carry)]."""
    out = []
    jc = tc = None
    for _ in range(2):
        jr, jc_new = jax_schedule_batch(js, jf, batch_pad, fit_strategy, VMAX,
                                        n_active=np.int32(n_active), carry_in=jc,
                                        has_pns=False, has_ipa_base=False)
        # Fetch before the next call: JAX donates carry_in.
        jr = np.asarray(jr)
        jc_np = [np.asarray(a) for a in jc_new]
        tr, tc = K.schedule_batch(ts, tf, batch_pad, fit_strategy, VMAX,
                                  n_active=n_active, carry_in=tc,
                                  has_pns=False, has_ipa_base=False)
        out.append((jr, jc_np, tr, tc))
        jc = JaxCarry(*[jnp.asarray(a) for a in jc_np])
    return out


@pytest.mark.parametrize("fit_strategy", [0, 1], ids=["least", "most"])
@pytest.mark.parametrize("batch_pad,n_active", [(512, 512), (512, 300), (64, 64), (64, 40)],
                         ids=["lap", "lap-padded", "scan", "scan-padded"])
@pytest.mark.parametrize("case", list(CASES))
def test_schedule_batch(case, batch_pad, n_active, fit_strategy):
    js, jf, ts, tf = _both(13, **CASES[case])
    for step, (jr, jc, tr, tc) in enumerate(_chain(js, jf, ts, tf, batch_pad,
                                                   fit_strategy, n_active)):
        assert tr.dtype == torch.int32 and tuple(tr.shape) == (2, batch_pad)
        np.testing.assert_array_equal(jr, tr.numpy(), err_msg=f"results, batch {step}")
        assert len(tc) == 14
        _same(jc, tc, f"carry, batch {step}")


def test_carry_across_round_trips_a_jax_carry():
    js, jf, ts, tf = _both(14)
    _jr, jc = jax_schedule_batch(js, jf, 512, 0, VMAX, n_active=np.int32(100),
                                 has_pns=False, has_ipa_base=False)
    jc_np = [np.asarray(a) for a in jc]
    tc = carry_from_jax_numpy(jc_np)
    _same(jc_np, tc, "carry_from_jax_numpy")
    # A JAX carry continues on the port exactly as it would on JAX.
    jr2, jc2 = jax_schedule_batch(js, jf, 512, 0, VMAX, n_active=np.int32(100),
                                  carry_in=JaxCarry(*[jnp.asarray(a) for a in jc_np]),
                                  has_pns=False, has_ipa_base=False)
    tr2, tc2 = K.schedule_batch(ts, tf, 512, 0, VMAX, n_active=100, carry_in=tc,
                                has_pns=False, has_ipa_base=False)
    np.testing.assert_array_equal(np.asarray(jr2), tr2.numpy())
    _same(jc2, tc2, "chained from a JAX carry")


def test_general_plan_is_refused():
    _js, _jf, ts, tf = _both(15)
    with pytest.raises(NotImplementedError, match="PreferNoSchedule"):
        K.schedule_batch(ts, tf, 512, 0, VMAX, has_pns=True, has_ipa_base=False)


def test_wrappers_count_only_kernel_launches():
    # CPU tensors take the plain versions: no launch is counted.
    _js, _jf, ts, tf = _both(16)
    K.reset_launch_counts()
    K.schedule_batch(ts, tf, 64, 0, VMAX, n_active=10, has_pns=False, has_ipa_base=False)
    assert [w.launches for w in K.WRAPPERS] == [0, 0, 0, 0]
    # Neither CPU nor CUDA: refused, never silently computed elsewhere.
    meta = ts._replace(valid=ts.valid.to("meta"))
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        K.static_masks(meta, tf)


@pytest.fixture
def recorded_launches(monkeypatch):
    """A stand-in for the built library that records each launcher's C
    arguments, so the CUDA wrappers' marshalling runs on CPU tensors."""
    calls = []
    monkeypatch.setattr(K._build, "launcher",
                        lambda name: lambda *args: calls.append((name, args)) or 0)
    monkeypatch.setattr(K, "_stream", lambda device: 0)
    return calls


def test_launcher_signatures_are_read_from_the_sources():
    for name in K._build.KERNELS:
        sig = K._build.signature(name)
        assert sig[0] == K._build.Param("NP", None)
        assert all(p.dtype is not None for p in sig if p.name not in
                   ("NP", "T", "L", "R", "FR", "fit_strategy", "B", "n_act"))
        optional = {p.name for p in sig if p.optional}
        assert optional == ({"nom_req", "nom_pods"} if name == "resource_eval" else set())


def test_cuda_wrappers_pass_what_their_launchers_declare(recorded_launches):
    _js, _jf, ts, tf = _both(17)
    fit = K._resource_eval_plain(tf, 0, ts.alloc_r, ts.alloc_pods, ts.req_r, ts.nonzero,
                                 ts.pod_count)
    ext0 = K.fresh_carry(ts, tf, VMAX, fit)
    static_ok = K._static_masks_plain(ts, tf).static_ok
    K._static_masks_cuda(ts, tf)
    K._resource_eval_cuda(tf, 1, ts.alloc_r, ts.alloc_pods, ts.req_r, ts.nonzero, ts.pod_count)
    K._lap_schedule_cuda(ts, tf, 512, 0, ext0, static_ok, 300)
    K._scan_schedule_cuda(ts, tf, 64, 0, ext0, static_ok, 40)
    assert [name for name, _ in recorded_launches] == list(K._build.KERNELS)
    for name, args in recorded_launches:
        sig = K._build.signature(name)
        assert len(args) == len(sig) + 1  # and the stream
        for p, a in zip(sig, args):
            assert (a is None) if p.optional else isinstance(a, int), (name, p)


def _wrong_dtype(ts, tf):
    K._static_masks_cuda(ts, tf._replace(enable=tf.enable.to(torch.int64)))


def _wrong_feature_dtype(ts, tf):
    K._resource_eval_cuda(tf._replace(fit_weights=tf.fit_weights.to(torch.int32)), 0,
                          ts.alloc_r, ts.alloc_pods, ts.req_r, ts.nonzero, ts.pod_count)


def _null_pointer(ts, tf):
    K._marshal("static_masks", torch.device("cpu"), (8, 4, 2) + (None,) * 23)


def _wrong_count(ts, tf):
    K._marshal("lap_schedule", torch.device("cpu"), (8,))


def _wrong_device(ts, tf):
    # A feature left on another device than the node state.
    K._resource_eval_cuda(tf._replace(request=tf.request.to("meta")), 0, ts.alloc_r,
                          ts.alloc_pods, ts.req_r, ts.nonzero, ts.pod_count)


def _not_an_int(ts, tf):
    K._marshal("static_masks", torch.device("cpu"), (8.0,) + (None,) * 25)


@pytest.mark.parametrize("bad,err,match", [
    (_wrong_dtype, TypeError, "enable must be a torch.int32"),
    (_wrong_feature_dtype, TypeError, "fit_weights must be a torch.int64"),
    (_null_pointer, TypeError, "taint_key may not be null"),
    (_wrong_count, TypeError, "takes 32 arguments"),
    (_wrong_device, ValueError, "request on meta, expected cpu"),
    (_not_an_int, TypeError, "NP must be an int"),
], ids=["dtype", "feature-dtype", "null", "count", "device", "int"])
def test_launch_arguments_are_checked_before_the_launch(recorded_launches, bad, err, match):
    _js, _jf, ts, tf = _both(18)
    with pytest.raises(err, match=match):
        bad(ts, tf)
    assert recorded_launches == []
