"""File formats of the port's reading layer (port of ``pint_tpu/io``): par
files (:mod:`pint_torch.io.par`) and tim files in the tempo2, Princeton,
Parkes and ITOA layouts (:mod:`pint_torch.io.tim`).

Both parsers run under the strict, lenient or collect ingestion policy
(:func:`pint_torch.config.set_ingestion_policy`) and report problems as
typed :class:`~pint_torch.exceptions.ParSyntaxError` /
:class:`~pint_torch.exceptions.TimSyntaxError` or accumulated
:class:`~pint_torch.integrity.diagnostics.Diagnostics`.
"""

from pint_torch.io.par import (ParFileDict, format_parfile,  # noqa: F401
                               fortran_float, parse_parfile)
from pint_torch.io.tim import format_toa_line, read_tim_file  # noqa: F401
