"""The port's shape-bucketed serve batcher (``pint_torch/serving``) against
the JAX package's on the CPU.

``bucket_of`` on and past its ladders; ``pad_request`` padded equal to the
dedicated shape (1e-9 rel: the padded Gram is block-diagonal, the reference
pins the same); ``serve_kernel``, ``serve_fused`` (three Huber steps) and
``ShapeBatcher.run`` on the small stream stand-in's requests at three
sizes (one bucket, one padded batch lane) and a second bucket, against the
reference's: the requests themselves (``FitRequest.from_fitter``) at the
repo's residual bar (1e-10 s) and 1e-12 rel for the design, weights and
prior; then, served on the same residuals -- the reference's, since a
residual gap at the 1e-13 s rounding of the reference's jitted evaluation
is ~5e-9 of the small stand-in's chi2 --, the same buckets and batches,
errors, chi2 and the initial chi2 within 1e-9 rel and ``dx`` within 1e-9
of each column's error; the refusal of ``pool=`` and the usage errors of
a precision spec outside the reference's dtypes and accumulations (a
reduced spec is served; ``tests/test_torch_precision.py`` holds it).
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch

S = standin.SMALL_STREAM_SETTINGS
SIZES = (40, 56, 64, 80)


@pytest.mark.parametrize("n", [1, 3, 64, 65, 4096, 4097, 20000, 40000])
def test_bucket_of_matches_the_reference(n):
    from pint_torch.serving import DEFAULT_NTOA_BUCKETS, bucket_of
    from pint_tpu.serving.batcher import bucket_of as ref

    assert bucket_of(n, DEFAULT_NTOA_BUCKETS) == ref(n, DEFAULT_NTOA_BUCKETS)
    assert bucket_of(n, (3, 5)) == ref(n, (3, 5))


@pytest.fixture(scope="module")
def requests_both():
    """The reference's base fit of the small stream stand-in; the port's
    model set to its values; one request a size in each package."""
    from pint_torch.bridge import load_snapshot
    from pint_torch.gls_fitter import GLSFitter as PGLS
    from pint_torch.serving import FitRequest as PReq
    from pint_tpu.gls_fitter import GLSFitter as RGLS
    from pint_tpu.serving.batcher import FitRequest as RReq

    model, toas = standin.make_standin(S, full=False)
    f = RGLS(toas[standin.stream_rows(S)[0]], copy.deepcopy(model))
    f.fit_toas(maxiter=S["fit_maxiter"])
    m, b = load_snapshot(standin.export_state(model, toas), device="cpu")
    for p in f.model.design_param_names():
        m[p].value = float(getattr(f.model, p).value)
    ref, port = [], []
    for n in SIZES:
        keep = np.arange(b.ntoas) < n
        ref.append(RReq.from_fitter(RGLS(toas[np.arange(n)], f.model),
                                    request_id=str(n)))
        port.append(PReq.from_fitter(PGLS(b.select(keep, m), m),
                                     request_id=str(n)))
    return ref, port


def _on_ref_resids(port, ref):
    """The port's requests with the reference's residuals."""
    from pint_torch.serving import FitRequest

    return [FitRequest(M=p.M, r=r.r, w=p.w, phiinv=p.phiinv,
                       params=p.params, norm=p.norm,
                       request_id=p.request_id, device="cpu")
            for p, r in zip(port, ref)]


def test_requests_match_the_reference(requests_both):
    """The linearized systems: residuals within 1e-10 s, the design,
    weights and prior weights 1e-12 rel."""
    for r, p in zip(*requests_both):
        assert np.max(np.abs(p.r.numpy() - r.r)) <= 1e-10
        for a, bb in ((p.M.numpy(), r.M), (p.w.numpy(), r.w),
                      (p.phiinv.numpy(), r.phiinv)):
            assert np.allclose(a, bb, rtol=1e-12, atol=1e-300)
        assert p.params == tuple(r.params)


def test_padded_equals_dedicated(requests_both):
    """A request padded into (64, 32) and a batch rung gives the
    dedicated shape's step, errors and chi2 to 1e-9 rel."""
    from pint_torch.serving import pad_request, serve_kernel

    q = requests_both[1][0]
    n, k = q.M.shape
    ded = serve_kernel(*pad_request(q, n, k))
    pad = serve_kernel(*(x[None] for x in pad_request(q, 64, 32)))
    assert torch.allclose(pad[0][0, :k], ded[0], rtol=1e-9, atol=1e-300)
    assert torch.allclose(pad[1][0, :k], ded[1], rtol=1e-9, atol=0)
    for i in (2, 3):
        assert abs(float(pad[i][0]) / float(ded[i]) - 1.0) <= 1e-9


def _close(got, want):
    assert np.all(np.abs(got.dx - want.dx) <= 1e-9 * want.errors)
    assert np.allclose(got.errors, want.errors, rtol=1e-9, atol=0)
    assert abs(got.chi2 / want.chi2 - 1.0) <= 1e-9
    assert abs(got.chi2_initial / want.chi2_initial - 1.0) <= 1e-9


def test_shape_batcher_run_matches_the_reference(requests_both):
    """Three requests in the (64, 32) bucket at batch rung 4 (one padded
    lane), one in (256, 32): buckets, batches and each result."""
    from pint_torch.serving import ShapeBatcher
    from pint_tpu.serving.batcher import ShapeBatcher as RSB

    ref, port = requests_both
    port = _on_ref_resids(port, ref)
    want = RSB().run(ref)
    got = ShapeBatcher(device="cpu").run(port)
    assert [g.bucket for g in got] == [w.bucket for w in want] \
        == [(64, 32)] * 3 + [(256, 32)]
    assert [g.batch for g in got] == [w.batch for w in want] == [4] * 3 + [1]
    assert [g.compiles for g in got] == [0] * 4
    for g, w in zip(got, want):
        _close(g, w)
        assert g.request_id == w.request_id
        assert g.dpars(port[0]).keys() == w.dpars(ref[0]).keys()


@pytest.mark.parametrize("reweight", [None, "huber"])
def test_serve_fused_matches_the_reference(requests_both, reweight):
    """Three fused steps (plain and Huber) on the padded (64, 32) group:
    per step dx within 1e-9 of the column's error, chi2 1e-9 rel."""
    from pint_torch.serving import pad_request, serve_fused
    from pint_tpu.serving.batcher import pad_request as rpad
    from pint_tpu.serving.batcher import serve_fused as rfused

    ref, port = requests_both
    port = _on_ref_resids(port, ref)
    pops = tuple(torch.stack([pad_request(q, 64, 32)[j] for q in port[:3]])
                 for j in range(5))
    rops = tuple(np.stack([rpad(q, 64, 32)[j] for q in ref[:3]])
                 for j in range(5))
    got = serve_fused(steps=3, reweight=reweight)(*pops)
    want = [np.asarray(a) for a in rfused(steps=3, reweight=reweight)(*rops)]
    err = want[1]
    assert np.allclose(got[1].numpy(), err, rtol=1e-9, atol=0)
    assert np.all(np.abs(got[0].numpy() - want[0])
                  <= 1e-9 * err[:, None, :] + 1e-300)
    assert np.allclose(got[2].numpy(), want[2], rtol=1e-9, atol=0)
    assert np.allclose(got[3].numpy(), want[3], rtol=1e-9, atol=0)


def test_refusals():
    """``pool=`` waits for item 8; a precision spec outside the reference's
    dtypes and accumulations, bad shapes and step counts are usage errors
    (a reduced ``serve.gram`` spec is served since the precision layer)."""
    from pint_torch.fitter import UsageError
    from pint_torch.serving import (FitRequest, SegmentSpec, ShapeBatcher,
                                    serve_fused, serve_kernel)

    with pytest.raises(NotImplementedError, match="item 8"):
        ShapeBatcher(pool=object(), device="cpu")
    with pytest.raises(UsageError, match="compute_dtype"):
        SegmentSpec(segment="serve.gram", compute_dtype="float16")
    with pytest.raises(UsageError, match="accumulation"):
        SegmentSpec(segment="serve.gram", accumulation="kahan")
    spec = SegmentSpec(segment="serve.gram", compute_dtype="float32",
                       accumulation="two_prod")
    assert callable(serve_fused(spec=spec))
    z = torch.zeros((1, 4, 2), dtype=torch.float64)
    out = serve_kernel(z, z[..., 0], z[..., 0], z[:, 0], z[:, 0] + 1.0,
                       spec=spec)
    assert all(torch.equal(a, b) for a, b in zip(out, serve_kernel(
        z, z[..., 0], z[..., 0], z[:, 0], z[:, 0] + 1.0)))
    with pytest.raises(UsageError):
        serve_fused(steps=0)
    with pytest.raises(UsageError):
        serve_fused(reweight="tukey")
    with pytest.raises(UsageError):
        FitRequest(M=np.zeros((4, 2)), r=np.zeros(3), w=np.zeros(4),
                   phiinv=np.zeros(2), device="cpu")
