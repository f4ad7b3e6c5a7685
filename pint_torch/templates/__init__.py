"""Pulse-profile template machinery for photon-domain likelihoods (port of
``pint_tpu/templates/``): primitives and mixtures evaluate numpy phases on
the host or torch tensors on their device; the norms, the energy-dependent
forms and the template fitters are host numpy copies."""

from pint_torch.templates.lcfitters import (LCFitter, get_errors,
                                          make_err_plot)
from pint_torch.templates.lcnorm import NormAngles
from pint_torch.templates.lcprimitives import (
    LCGaussian,
    LCLorentzian,
    LCPrimitive,
    LCSkewGaussian,
    LCTopHat,
    LCVonMises,
    LCWrappedFunction,
    two_comp_mc,
)
from pint_torch.templates.lctemplate import (
    LCTemplate,
    gauss_template_from_file,
    make_twoside_gaussian,
    prim_io,
)

__all__ = [
    "LCFitter", "NormAngles", "LCGaussian", "LCLorentzian", "LCPrimitive",
    "LCSkewGaussian", "LCWrappedFunction", "two_comp_mc", "get_errors",
    "make_err_plot", "LCTopHat", "LCVonMises", "LCTemplate",
    "gauss_template_from_file", "make_twoside_gaussian", "prim_io",
]
