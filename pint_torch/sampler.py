"""MCMC samplers: the batched ensemble stretch move and the optional emcee
wrapper (port of ``pint_tpu/sampler.py``).

:class:`EnsembleSampler` is the Goodman & Weare (2010) affine-invariant
stretch move with each half-ensemble evaluated through one batched
lnposterior call (``BayesianTiming.lnposterior_batch``, on the model's
device).  The bookkeeping -- stretch factors, partners, proposals, accept
draws, the chain -- stays on the host in numpy with
``np.random.default_rng(seed)``, so for the same posterior values a chain
is the reference's bit for bit.  :class:`NpzBackend` checkpoints a chain
with the generator's exact state, so a resumed run continues it
bit-identically.

A batched evaluation that fails in a device-shaped way is retried with
exponential backoff (:func:`pint_torch.runtime.checkpoint.with_retries`,
as the reference's is); any other failure propagates.  Walker meshes and
execution plans are ROADMAP queue A item 9; the telemetry counters item 8.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, List, Optional

import numpy as np

from pint_torch.logging import log
from pint_torch.runtime.checkpoint import RetryPolicy, with_retries

__all__ = ["MCMCSampler", "EnsembleSampler", "EmceeSampler", "NpzBackend",
           "integrated_autocorr_time", "run_sampler_autocorr"]



def _next_pow_two(n: int) -> int:
    i = 1
    while i < n:
        i <<= 1
    return i


def _acf_1d(x: np.ndarray) -> np.ndarray:
    """Normalized autocorrelation of a 1-D series via FFT (the emcee
    ``function_1d`` algorithm)."""
    x = np.asarray(x, dtype=np.float64)
    n = _next_pow_two(len(x))
    f = np.fft.fft(x - np.mean(x), n=2 * n)
    acf = np.fft.ifft(f * np.conjugate(f))[: len(x)].real
    if acf[0] == 0:
        return np.ones_like(acf)
    return acf / acf[0]


def integrated_autocorr_time(chain: np.ndarray, c: float = 5.0) -> np.ndarray:
    """Per-parameter integrated autocorrelation time of an ensemble chain
    (emcee's Sokal-windowed estimator).

    ``chain`` is (nsteps, nwalkers, ndim); the ACF is averaged over walkers
    per parameter and summed up to the automatic window
    ``min { m : m >= c * tau(m) }``.
    """
    chain = np.asarray(chain, dtype=np.float64)
    if chain.ndim != 3:
        raise ValueError("chain must be (nsteps, nwalkers, ndim)")
    nsteps, nwalkers, ndim = chain.shape
    taus = np.empty(ndim)
    for k in range(ndim):
        f = np.zeros(nsteps)
        for w in range(nwalkers):
            f += _acf_1d(chain[:, w, k])
        f /= nwalkers
        tau_m = 2.0 * np.cumsum(f) - 1.0
        m = np.arange(nsteps)
        window = np.argmax(m >= c * tau_m) if np.any(m >= c * tau_m) \
            else nsteps - 1
        taus[k] = tau_m[window]
    return taus


def run_sampler_autocorr(sampler, pos, nsteps: int, burnin: int,
                         csteps: int = 100, crit1: int = 10):
    """Run *sampler* until the autocorrelation-time convergence criteria
    hold (reference ``scripts/event_optimize.py:239``): first the chain must
    exceed ``crit1`` autocorrelation times with tau stable to 10% (checked
    every ``csteps``), then stable to 1% (checked every ``csteps/4``), with
    at least 1000 post-burnin steps.  Returns the list of mean-tau
    estimates."""
    autocorr = []
    old_tau = np.inf
    converged1 = converged2 = False
    converge_step = None
    for _ in sampler.sample(pos, iterations=nsteps):
        it = sampler.iteration
        if not converged1:
            if it >= burnin and it % csteps == 0:
                tau = sampler.get_autocorr_time(tol=0, quiet=True)
                if np.any(np.isnan(tau)):
                    continue
                autocorr.append(float(np.mean(tau)))
                converged1 = bool(np.all(tau * crit1 < it)
                                  and np.all(np.abs(old_tau - tau) / tau < 0.1))
                old_tau = tau
                if converged1:
                    log.info(f"10% convergence reached with a mean estimated "
                             f"integrated step: {autocorr[-1]}")
            continue
        if not converged2:
            if it % max(int(csteps / 4), 1) == 0:
                tau = sampler.get_autocorr_time(tol=0, quiet=True)
                if np.any(np.isnan(tau)):
                    continue
                autocorr.append(float(np.mean(tau)))
                converged2 = bool(np.all(tau * crit1 < it)
                                  and np.all(np.abs(old_tau - tau) / tau < 0.01))
                old_tau = tau
                converge_step = it
        if converged2 and (it - burnin) >= 1000:
            log.info(f"Convergence reached at {converge_step}")
            break
    return autocorr


class NpzBackend:
    """Checkpoint/resume backend for :class:`EnsembleSampler`: the chain,
    log-probs, acceptance counters and the exact generator state, so a
    resumed run continues the Markov chain bit-identically to an
    uninterrupted one."""

    def __init__(self, path: str):
        # np.savez appends '.npz' to bare names; normalize so save and
        # load always address the same file
        path = str(path)
        self.path = path if path.endswith(".npz") else path + ".npz"

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def save(self, sampler: "EnsembleSampler") -> None:
        # atomic write (tmp + rename): a crash mid-save must not corrupt
        # the only checkpoint
        tmp = self.path + ".tmp.npz"
        np.savez(
            tmp,
            chain=np.asarray(sampler._chain),
            lnprob=np.asarray(sampler._lnprob),
            naccepted=sampler.naccepted,
            ntotal=sampler.ntotal,
            nwalkers=sampler.nwalkers,
            a=sampler.a,
            ndim=sampler.ndim if sampler.ndim is not None else -1,
            fingerprint=np.array(sampler.fingerprint or ""),
            rng_state=np.frombuffer(
                pickle.dumps(sampler.rng.bit_generator.state), dtype=np.uint8),
        )
        os.replace(tmp, self.path)

    def load_into(self, sampler: "EnsembleSampler") -> np.ndarray:
        """Restore state; returns the last walker positions to resume from."""
        with np.load(self.path, allow_pickle=False) as d:
            if int(d["nwalkers"]) != sampler.nwalkers:
                raise ValueError(
                    f"backend has {int(d['nwalkers'])} walkers, sampler has "
                    f"{sampler.nwalkers}")
            stored_fp = str(d["fingerprint"]) if "fingerprint" in d else ""
            if sampler.fingerprint and stored_fp \
                    and stored_fp != sampler.fingerprint:
                from pint_torch.runtime.checkpoint import CheckpointError

                raise CheckpointError(
                    f"{self.path}: checkpoint belongs to a different run "
                    "(model/TOAs fingerprint mismatch); refusing to "
                    "continue the wrong chain -- delete the file to start "
                    "over")
            sampler._chain = list(d["chain"])
            sampler._lnprob = list(d["lnprob"])
            sampler.naccepted = int(d["naccepted"])
            sampler.ntotal = int(d["ntotal"])
            if int(d["ndim"]) >= 0:
                sampler.ndim = int(d["ndim"])
            sampler.rng.bit_generator.state = pickle.loads(
                d["rng_state"].tobytes())
        if not sampler._chain:
            raise ValueError("backend contains no steps")
        return sampler._chain[-1]


class MCMCSampler:
    """Abstract sampler interface (reference ``sampler.py:7``)."""

    def __init__(self):
        self.method = None

    def initialize_sampler(self, lnpostfn, ndim: int):
        raise NotImplementedError

    def get_initial_pos(self, fitkeys, fitvals, fiterrs, errfact, **kw):
        """Gaussian ball around the fit values (reference ``sampler.py:43``)."""
        fitvals = np.asarray(fitvals, dtype=np.float64)
        fiterrs = np.asarray(fiterrs, dtype=np.float64)
        scale = np.where(fiterrs > 0, fiterrs,
                         np.abs(fitvals) * 1e-8 + 1e-12) * errfact
        rng = np.random.default_rng(kw.get("seed"))
        return fitvals + scale * rng.standard_normal((self.nwalkers, len(fitvals)))

    def run_mcmc(self, pos, nsteps):
        raise NotImplementedError


class EnsembleSampler(MCMCSampler):
    """Affine-invariant stretch-move ensemble sampler, batched.

    ``lnpost_batch`` maps an (N, ndim) array of walker positions to (N,)
    log-posteriors -- e.g. ``BayesianTiming.lnposterior_batch``.  The two
    half-ensembles update alternately (the parallelizable variant of
    Goodman & Weare 2010), so detailed balance holds while every posterior
    evaluation is batched.

    ``mesh`` and ``plan`` (walker meshes, ROADMAP queue A item 9) must stay
    None.  ``retries`` and ``retry_backoff`` make the :class:`RetryPolicy`
    under which every batched evaluation runs (``retry_policy``): a
    device-shaped failure is retried, anything else propagates.  Setting
    ``decision_log`` to a
    list records, per half-ensemble update, ``(lnratio - log u, lp_prop)``
    -- each decision's margin and the proposals' log-posteriors -- for
    checks of a chain against another package's.
    """

    def __init__(self, nwalkers: int, a: float = 2.0,
                 seed: Optional[int] = None, backend=None,
                 checkpoint_every: int = 50, mesh=None, plan=None,
                 retries: int = 2, retry_backoff: float = 0.5):
        super().__init__()
        if nwalkers % 2:
            raise ValueError("nwalkers must be even (half-ensemble updates)")
        if mesh is not None or plan is not None:
            raise NotImplementedError(
                "walker meshes and execution plans are ROADMAP queue A "
                "item 9")
        self.nwalkers = nwalkers
        self.retry_policy = RetryPolicy(max_retries=retries,
                                        backoff_base=retry_backoff)
        self.a = a
        self.rng = np.random.default_rng(seed)
        self.method = "stretch"
        self._lnpost_batch: Optional[Callable] = None
        self.ndim = None
        self._chain: List[np.ndarray] = []
        self._lnprob: List[np.ndarray] = []
        self.naccepted = 0
        self.ntotal = 0
        self.backend = (NpzBackend(backend) if isinstance(backend, str)
                        else backend)
        self.checkpoint_every = checkpoint_every
        #: optional run-identity string (see runtime.checkpoint
        #: fingerprint_of); when set, saved into checkpoints and verified
        #: on resume so a checkpoint from a different model/TOAs cannot
        #: silently continue the wrong chain
        self.fingerprint: Optional[str] = None
        self.decision_log: Optional[list] = None

    def _eval_lnpost(self, pts: np.ndarray) -> np.ndarray:
        """The batched lnposterior under :attr:`retry_policy`."""
        return with_retries(
            lambda: np.array(self._lnpost_batch(pts), dtype=np.float64),
            self.retry_policy, what="lnposterior batch")

    def resume(self) -> np.ndarray:
        """Restore chain + RNG state from the backend; returns the walker
        positions to continue from."""
        if self.backend is None:
            raise ValueError("no backend configured")
        pos = self.backend.load_into(self)
        log.info(f"Resumed {len(self._chain)} steps from "
                 f"{self.backend.path}")
        return pos

    def initialize_sampler(self, lnpostfn, ndim: int):
        """``lnpostfn`` may be scalar (point -> float) or batched
        ((N, ndim) -> (N,)); batched callables must expose ``.batched = True``
        or be passed via :meth:`initialize_batched`."""
        self.ndim = ndim
        if getattr(lnpostfn, "batched", False):
            self._lnpost_batch = lnpostfn
        else:
            self._lnpost_batch = lambda pts: np.array(
                [lnpostfn(p) for p in np.asarray(pts)])

    def initialize_batched(self, lnpost_batch: Callable, ndim: int):
        self.ndim = ndim
        self._lnpost_batch = lnpost_batch

    def _one_step(self, x: np.ndarray, lp: np.ndarray, step: int):
        """One full ensemble update (both half-ensembles), in place."""
        n, ndim = x.shape
        half = n // 2
        for first in (True, False):
            s = slice(0, half) if first else slice(half, n)
            o = slice(half, n) if first else slice(0, half)
            xs, xo = x[s], x[o]
            # z ~ g(z) propto 1/sqrt(z) on [1/a, a]
            u = self.rng.random(half)
            z = ((self.a - 1.0) * u + 1.0) ** 2 / self.a
            partners = self.rng.integers(0, half, size=half)
            prop = xo[partners] + z[:, None] * (xs - xo[partners])
            lp_prop = self._eval_lnpost(prop)
            lnratio = (ndim - 1) * np.log(z) + lp_prop - lp[s]
            logu = np.log(self.rng.random(half))
            accept = logu < lnratio
            if self.decision_log is not None:
                self.decision_log.append((lnratio - logu, lp_prop.copy()))
            x[s] = np.where(accept[:, None], prop, xs)
            lp_s = lp[s]
            lp_s[accept] = lp_prop[accept]
            lp[s] = lp_s
            self.naccepted += int(accept.sum())
            self.ntotal += half
        self._chain.append(x.copy())
        self._lnprob.append(lp.copy())
        if (self.backend is not None
                and (step + 1) % self.checkpoint_every == 0):
            self.backend.save(self)
            # each save rewrites the whole chain; grow the interval so
            # cumulative checkpoint I/O stays ~linear in chain length
            if len(self._chain) >= 20 * self.checkpoint_every:
                self.checkpoint_every *= 2

    def run_mcmc(self, pos, nsteps: int, progress: bool = False) -> np.ndarray:
        """Advance the ensemble *nsteps*; returns the final position."""
        x = np.array(pos, dtype=np.float64)
        for x in self.sample(pos, nsteps):
            pass
        return x

    def sample(self, pos, iterations: int, progress: bool = False):
        """Generator yielding the current position after every step
        (emcee-compatible incremental API; consumed by
        :func:`run_sampler_autocorr`).  The final backend checkpoint runs
        even when the consumer breaks out early (convergence), so a resume
        always continues the exact chain that was reported."""
        x = np.array(pos, dtype=np.float64)
        if x.shape[0] != self.nwalkers:
            raise ValueError(
                f"pos has {x.shape[0]} walkers, expected {self.nwalkers}")
        lp = self._eval_lnpost(x)
        try:
            for step in range(iterations):
                self._one_step(x, lp, step)
                yield x
        finally:
            if self.backend is not None:
                self.backend.save(self)

    @property
    def iteration(self) -> int:
        """Number of steps accumulated in the chain (emcee-compatible)."""
        return len(self._chain)

    def get_autocorr_time(self, tol: float = 50.0, quiet: bool = False,
                          discard: int = 0, c: float = 5.0) -> np.ndarray:
        """Per-parameter integrated autocorrelation time (emcee-compatible
        semantics: with ``tol>0`` a chain shorter than ``tol*tau`` raises,
        or warns with ``quiet=True``)."""
        chain = self.get_chain(discard=discard)
        if len(chain) < 2:
            return np.full(self.ndim or 1, np.nan)
        tau = integrated_autocorr_time(chain, c=c)
        if tol > 0 and np.any(tau * tol > len(chain)):
            msg = (f"The chain is shorter than {tol} times the integrated "
                   f"autocorrelation time for {int(np.sum(tau * tol > len(chain)))} "
                   f"parameter(s); tau estimates are unreliable")
            if not quiet:
                raise RuntimeError(msg)
            log.warning(msg)
        return tau

    @property
    def acceptance_fraction(self) -> float:
        return self.naccepted / max(self.ntotal, 1)

    def get_chain(self, flat: bool = False, discard: int = 0,
                  thin: int = 1) -> np.ndarray:
        """(nsteps, nwalkers, ndim) chain (emcee-compatible layout)."""
        c = np.array(self._chain)[discard::thin]
        return c.reshape(-1, self.ndim) if flat else c

    def get_log_prob(self, flat: bool = False, discard: int = 0,
                     thin: int = 1) -> np.ndarray:
        lp = np.array(self._lnprob)[discard::thin]
        return lp.reshape(-1) if flat else lp

    def chains_to_dict(self, names: List[str]) -> Dict[str, np.ndarray]:
        chain = self.get_chain()
        return {name: chain[:, :, i] for i, name in enumerate(names)}

    def reset(self):
        self._chain, self._lnprob = [], []
        self.naccepted = self.ntotal = 0


class EmceeSampler(MCMCSampler):
    """Reference-parity wrapper over emcee (optional dependency;
    reference ``sampler.py:60``)."""

    def __init__(self, nwalkers: int):
        super().__init__()
        try:
            import emcee  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "emcee is not installed; use pint_torch.sampler."
                "EnsembleSampler (batched) instead") from e
        self.nwalkers = nwalkers
        self.sampler = None
        self.method = "emcee"

    def is_initialized(self) -> bool:
        return self.sampler is not None

    def initialize_sampler(self, lnpostfn, ndim: int):
        import emcee

        self.ndim = ndim
        self.sampler = emcee.EnsembleSampler(self.nwalkers, ndim, lnpostfn)

    def run_mcmc(self, pos, nsteps):
        return self.sampler.run_mcmc(pos, nsteps)

    def sample(self, pos, iterations, progress: bool = False):
        """Incremental sampling passthrough so
        :func:`run_sampler_autocorr` drives emcee the same way it drives
        the batched ensemble."""
        return self.sampler.sample(pos, iterations=iterations,
                                   progress=progress)

    @property
    def iteration(self) -> int:
        return self.sampler.iteration

    def get_autocorr_time(self, **kw):
        return self.sampler.get_autocorr_time(**kw)

    def get_chain(self, **kw):
        return self.sampler.get_chain(**kw)

    def get_log_prob(self, **kw):
        return self.sampler.get_log_prob(**kw)

    @property
    def acceptance_fraction(self) -> float:
        return float(np.mean(self.sampler.acceptance_fraction))

    def chains_to_dict(self, names):
        chains = [self.sampler.chain[:, :, ii].T for ii in range(len(names))]
        return dict(zip(names, chains))
