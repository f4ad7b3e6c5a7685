"""Keplerian orbit propagation with derivatives (port of
``pint_tpu/orbital/kepler.py``: the anomalies, the Kepler mass and
``btx_parameters`` :27-82; the 2-D, 3-D and two-body cores :85-155; the
evaluation with its Jacobian :166; the forward and inverse functions
:183-273).

Times are in days, distances in light-seconds, masses in solar masses.
Each variant is one torch function of its input vector, and its partial
derivatives are ``torch.func.jacfwd`` of that same function, so values and
derivatives cannot drift apart.  The forward functions take scalar
elements (one orbit) or equal-length arrays of them (a batch, through
``torch.func.vmap``) and return float64 tensors on ``device`` (default
``"cuda"``).  The anomaly helpers and the inverse (state -> elements)
functions stay host numpy, as in the reference.
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch
from torch.func import jacfwd, vmap

from pint_torch import F64, resolve_device
from pint_torch.models.binary.engines import solve_kepler

__all__ = ["G", "true_from_eccentric", "eccentric_from_mean", "mass",
           "mass_partials", "btx_parameters", "Kepler2DParameters",
           "Kepler3DParameters", "KeplerTwoBodyParameters", "kepler_2d",
           "kepler_3d", "kepler_two_body", "inverse_kepler_2d",
           "inverse_kepler_3d", "inverse_kepler_two_body"]

#: gravitational constant in ls^3 / (Msun day^2)
G = 36768.59290949113

#: nudge for an exactly circular orbit: atan2 at (0, 0) has no derivative;
#: the induced error is ~1e-30 in every output
_TINY_E = 1e-30


def true_from_eccentric(e, eccentric_anomaly):
    """(true anomaly, d/de, d/dE) from the eccentric anomaly."""
    nu = 2 * np.arctan2(np.sqrt(1 + e) * np.sin(eccentric_anomaly / 2),
                        np.sqrt(1 - e) * np.cos(eccentric_anomaly / 2))
    denom = 1 - e * np.cos(eccentric_anomaly)
    nu_de = np.sin(eccentric_anomaly) / (np.sqrt(1 - e**2) * denom)
    nu_prime = np.sqrt(1 - e**2) / denom
    return nu, nu_de, nu_prime


def eccentric_from_mean(e, mean_anomaly):
    """(eccentric anomaly, [d/de, d/dM]) by a step-clamped Newton solve of
    Kepler's equation; raises if it does not converge."""
    E = mean_anomaly + e * np.sin(mean_anomaly)
    for _ in range(60):
        f = E - e * np.sin(E) - mean_anomaly
        E = E - np.clip(f / (1 - e * np.cos(E)), -1.0, 1.0)
    if np.any(np.abs(E - e * np.sin(E) - mean_anomaly) > 1e-10):
        raise RuntimeError(
            f"Kepler solve did not converge (e={e}, M={mean_anomaly})")
    denom = 1 - e * np.cos(E)
    return E, [np.sin(E) / denom, 1.0 / denom]


def mass(a, pb):
    """Kepler mass from semimajor axis [ls] and period [days]."""
    return 4 * np.pi**2 * a**3 / (pb**2 * G)


def mass_partials(a, pb):
    """(mass, [dm/da, dm/dpb])."""
    m = mass(a, pb)
    return m, np.array([3 * m / a, -2 * m / pb])


def btx_parameters(asini, pb, eps1, eps2, tasc):
    """ELL1 -> BTX elements: (asini, pb, ecc, om, t0)."""
    e = np.hypot(eps1, eps2)
    om = np.arctan2(eps1, eps2)
    nu0 = -om  # true anomaly at the ascending node
    E0 = np.arctan2(np.sqrt(1 - e**2) * np.sin(nu0), e + np.cos(nu0))
    M0 = E0 - e * np.sin(E0)
    return asini, pb, e, om, tasc - M0 * pb / (2 * np.pi)


Kepler2DParameters = collections.namedtuple(
    "Kepler2DParameters", "a pb eps1 eps2 t0")
Kepler3DParameters = collections.namedtuple(
    "Kepler3DParameters", "a pb eps1 eps2 i lan t0")
KeplerTwoBodyParameters = collections.namedtuple(
    "KeplerTwoBodyParameters",
    "a pb eps1 eps2 i lan q x_cm y_cm z_cm vx_cm vy_cm vz_cm tasc")


def _kepler_2d_core(vec):
    """(x, y, vx, vy) from [a, pb, eps1, eps2, t0, t]: the core every
    variant builds on (Kepler's equation by 30 clamped Newton steps)."""
    a, pb, eps1, eps2, t0, t = (vec[i] for i in range(6))
    e = torch.hypot(eps1, eps2)
    om = torch.atan2(eps1, eps2)
    nu0 = -om
    E0 = torch.atan2(torch.sqrt(1 - e**2) * torch.sin(nu0),
                     e + torch.cos(nu0))
    M0 = E0 - e * torch.sin(E0)
    M = 2 * math.pi * (t - t0) / pb + M0
    E = solve_kepler(M, e, niter=30)
    nu = 2 * torch.atan2(torch.sqrt(1 + e) * torch.sin(E / 2),
                         torch.sqrt(1 - e) * torch.cos(E / 2))
    E_dot = (2 * math.pi / pb) / (1 - e * torch.cos(E))
    nu_dot = torch.sqrt(1 - e**2) / (1 - e * torch.cos(E)) * E_dot
    r = a * (1 - e**2) / (1 + e * torch.cos(nu))
    r_dot = (a * e * (1 - e**2) * torch.sin(nu)
             / (1 + e * torch.cos(nu)) ** 2) * nu_dot
    cpsi, spsi = torch.cos(nu + om), torch.sin(nu + om)
    return torch.stack([r * cpsi, r * spsi,
                        r_dot * cpsi - r * nu_dot * spsi,
                        r_dot * spsi + r * nu_dot * cpsi])


def _kepler_3d_core(vec):
    """(x, y, z, vx, vy, vz) from [a, pb, eps1, eps2, i, lan, t0, t]: the
    2-D orbit rotated by the inclination (about x), then by the node's
    longitude (about z)."""
    a, pb, eps1, eps2, inc, lan, t0, t = (vec[i] for i in range(8))
    xv = _kepler_2d_core(torch.stack([a, pb, eps1, eps2, t0, t]))
    zero = torch.zeros_like(a)
    one = torch.ones_like(a)
    pos = torch.stack([xv[0], xv[1], zero])
    vel = torch.stack([xv[2], xv[3], zero])
    ci, si = torch.cos(inc), torch.sin(inc)
    r_i = torch.stack([torch.stack([one, zero, zero]),
                       torch.stack([zero, ci, -si]),
                       torch.stack([zero, si, ci])])
    cl, sl = torch.cos(lan), torch.sin(lan)
    r_lan = torch.stack([torch.stack([cl, sl, zero]),
                         torch.stack([-sl, cl, zero]),
                         torch.stack([zero, zero, one])])
    rot = r_lan @ r_i
    return torch.cat([rot @ pos, rot @ vel])


def _kepler_two_body_core(vec):
    """14-component state [xv_p (6), m_p, xv_c (6), m_c] from the 15
    inputs [a, pb, eps1, eps2, i, lan, q, x_cm (3), v_cm (3), tasc, t]."""
    a, pb, eps1, eps2, inc, lan, q = (vec[i] for i in range(7))
    x_cm = vec[7:10]
    v_cm = vec[10:13]
    tasc, t = vec[13], vec[14]
    a_tot = a + a / q
    m_tot = 4 * math.pi**2 * a_tot**3 / (pb**2 * G)
    m_p = m_tot / (1 + q)
    m_c = q * m_p
    xv_tot = _kepler_3d_core(torch.stack([a_tot, pb, eps1, eps2, inc, lan,
                                          tasc, t]))
    xv_p = xv_tot / (1 + 1.0 / q)
    xv_c = -xv_p / q
    cm6 = torch.cat([x_cm, v_cm])
    return torch.cat([xv_p + cm6, torch.stack([m_p]),
                      xv_c + cm6, torch.stack([m_c])])


def _inputs(values, device) -> torch.Tensor:
    """The core's input vector (n,) for scalar elements, or (K, n) for
    arrays of K orbits, with an exactly circular orbit's eps1 nudged to
    :data:`_TINY_E` (``values[2:4]`` are eps1, eps2)."""
    cols = np.broadcast_arrays(*[np.asarray(v, dtype=np.float64)
                                 for v in values])
    vec = np.stack(cols, axis=-1)
    circular = (vec[..., 2] == 0.0) & (vec[..., 3] == 0.0)
    vec[..., 2] = np.where(circular, _TINY_E, vec[..., 2])
    return torch.as_tensor(vec, dtype=F64, device=resolve_device(device))


def _eval_with_jac(core, vec: torch.Tensor):
    """(core(vec), its Jacobian): (m,), (m, n) for one orbit; (K, m),
    (K, m, n) for K."""
    if vec.ndim == 1:
        return core(vec), jacfwd(core)(vec)
    return vmap(core)(vec), vmap(jacfwd(core))(vec)


def kepler_2d(params: Kepler2DParameters, t, device=None):
    """((x, y, vx, vy), partials (4, 6)) of a 2-D Kepler orbit; partial j
    is with respect to (a, pb, eps1, eps2, t0, t)."""
    return _eval_with_jac(_kepler_2d_core, _inputs(
        [params.a, params.pb, params.eps1, params.eps2, params.t0, t],
        device))


def kepler_3d(params: Kepler3DParameters, t, device=None):
    """((x, y, z, vx, vy, vz), partials (6, 8)) with respect to (a, pb,
    eps1, eps2, i, lan, t0, t)."""
    return _eval_with_jac(_kepler_3d_core, _inputs(
        [params.a, params.pb, params.eps1, params.eps2, params.i,
         params.lan, params.t0, t], device))


def kepler_two_body(params: KeplerTwoBodyParameters, t, device=None):
    """((xv_p, m_p, xv_c, m_c) 14-state, partials (14, 15)) of a two-body
    system about its center of mass."""
    return _eval_with_jac(_kepler_two_body_core, _inputs(
        [params.a, params.pb, params.eps1, params.eps2, params.i,
         params.lan, params.q, params.x_cm, params.y_cm, params.z_cm,
         params.vx_cm, params.vy_cm, params.vz_cm, params.tasc, t], device))


def inverse_kepler_2d(xv, m, t) -> Kepler2DParameters:
    """Osculating 2-D elements from a state vector; t0 lands within half a
    period of t."""
    xv = np.asarray(xv, dtype=np.float64)
    mu = G * m
    h = xv[0] * xv[3] - xv[1] * xv[2]  # specific angular momentum
    r = np.hypot(xv[0], xv[1])
    # Laplace-Runge-Lenz direction gives the eccentricity components
    eps2, eps1 = np.array([xv[3], -xv[2]]) * h / mu - xv[:2] / r
    e = np.hypot(eps1, eps2)
    a = (h**2 / mu) / (1 - e**2)
    pb = 2 * np.pi * np.sqrt(a**3 / mu)
    om = np.arctan2(eps1, eps2)

    def mean_from_true(nu):
        E = np.arctan2(np.sqrt(1 - e**2) * np.sin(nu), e + np.cos(nu))
        return E - e * np.sin(E)

    M = mean_from_true(np.arctan2(xv[1], xv[0]) - om)
    M0 = mean_from_true(-om)
    return Kepler2DParameters(a=a, pb=pb, eps1=eps1, eps2=eps2,
                              t0=t - (M - M0) * pb / (2 * np.pi))


def inverse_kepler_3d(xyv, m, t) -> Kepler3DParameters:
    """Osculating 3-D elements from a state vector."""
    xyv = np.asarray(xyv, dtype=np.float64)
    L = np.cross(xyv[:3], xyv[3:])
    inc = np.arccos(L[2] / np.linalg.norm(L))
    lan = (-np.arctan2(L[0], -L[1])) % (2 * np.pi)
    cl, sl = np.cos(lan), np.sin(lan)
    r_lan = np.array([[cl, sl, 0.0], [-sl, cl, 0.0], [0.0, 0.0, 1.0]])
    ci, si = np.cos(inc), np.sin(inc)
    r_i = np.array([[1.0, 0.0, 0.0], [0.0, ci, -si], [0.0, si, ci]])
    # undo node-then-inclination: the inverses in reverse order
    back = r_i.T @ r_lan.T
    pos = back @ xyv[:3]
    vel = back @ xyv[3:]
    p2 = inverse_kepler_2d(np.array([pos[0], pos[1], vel[0], vel[1]]), m, t)
    return Kepler3DParameters(a=p2.a, pb=p2.pb, eps1=p2.eps1, eps2=p2.eps2,
                              i=inc, lan=lan, t0=p2.t0)


def inverse_kepler_two_body(total_state, t) -> KeplerTwoBodyParameters:
    """Two-body elements from the 14-component state."""
    s = np.asarray(total_state, dtype=np.float64)
    x_p, v_p, m_p = s[:3], s[3:6], s[6]
    x_c, v_c, m_c = s[7:10], s[10:13], s[13]
    x_cm = (m_p * x_p + m_c * x_c) / (m_p + m_c)
    v_cm = (m_p * v_p + m_c * v_c) / (m_p + m_c)
    rel = np.concatenate([x_p - x_c, v_p - v_c])
    p3 = inverse_kepler_3d(rel, m_p + m_c, t)
    q = m_c / m_p
    a = p3.a / (1 + 1.0 / q)
    return KeplerTwoBodyParameters(
        a=a, pb=p3.pb, eps1=p3.eps1, eps2=p3.eps2, i=p3.i, lan=p3.lan, q=q,
        x_cm=x_cm[0], y_cm=x_cm[1], z_cm=x_cm[2],
        vx_cm=v_cm[0], vy_cm=v_cm[1], vz_cm=v_cm[2], tasc=p3.t0)
