"""Phase jumps between receiver/backend groups and tempo-style delay
jumps (port of ``pint_tpu/models/jump.py:19-47,118-147``): JUMPs are mask
parameters whose 0/1 masks are built on the host."""

from __future__ import annotations

import torch

from pint_torch.models.parameter import maskParameter
from pint_torch.models.timing_model import DelayComponent, PhaseComponent
from pint_torch.phase import Phase

__all__ = ["PhaseJump", "DelayJump"]


class PhaseJump(PhaseComponent):
    """Config: ``jumps`` (names); context: ``masks`` {name: (N,)}."""

    register = True
    category = "phase_jump"

    def declare(self):
        self.add_param(maskParameter(
            "JUMP", index=1, units="s", value=0.0,
            description="Phase jump (seconds) for selected TOAs"))

    def setup(self):
        self.config["jumps"] = [p for p in self.params
                                if p.startswith("JUMP")]

    def host_context(self, toas):
        return {"masks": self._select_masks(toas, self.config["jumps"])}

    def phase_func(self, pv, batch, ctx, delay) -> Phase:
        jphase = torch.zeros_like(batch.freq)
        F0 = pv.get("F0", 0.0)
        for j in self.config["jumps"]:
            jphase = jphase + pv.get(j, 0.0) * F0 * ctx["masks"][j]
        return Phase.from_float(jphase)

    # -- the jump editing of pintk (reference ``jump.py:55-122``) ---------
    def add_jump_and_flags(self, toa_flags, value: float = 0.0,
                           frozen: bool = False) -> str:
        """A new jump over the TOAs whose flag dicts are ``toa_flags``
        (each stamped ``-gui_jump <n>``, n one past the jumps' largest);
        JUMP1 is reused while it is the unset one the component declares.
        Returns the jump's name."""
        table = self._parent.params_table
        used = []
        for j in self.config["jumps"]:
            if table[j].key == "-gui_jump":
                used += [int(v) for v in table[j].key_value]
        ind = max(used, default=0) + 1
        toa_flags = list(toa_flags)
        for fl in toa_flags:
            if fl.get("gui_jump"):
                raise ValueError(
                    "A selected TOA is already jumped by a gui jump; "
                    "unjump it first")
        for fl in toa_flags:
            fl["gui_jump"] = str(ind)
        ex = table.get("JUMP1")
        if len(self.config["jumps"]) == 1 and ex is not None \
                and ex.key is None:
            ex.key, ex.key_value = "-gui_jump", [str(ind)]
            ex.value, ex.frozen = float(value), frozen
            name = "JUMP1"
        else:
            idx = max((int(j[4:]) for j in self.config["jumps"]),
                      default=0) + 1
            self.add_param(maskParameter("JUMP", index=idx, key="-gui_jump",
                                         key_value=[str(ind)], units="s",
                                         value=float(value), frozen=frozen),
                           setup=True)
            name = f"JUMP{idx}"
        self.setup()
        self._parent.setup()
        return name

    def delete_not_all_jump_toas(self, toa_flags, jump_num: int) -> None:
        """Take the ``-gui_jump <jump_num>`` flag off the given TOAs; the
        jump stays."""
        for fl in (toa_flags or []):
            if fl.get("gui_jump") == str(int(jump_num)):
                del fl["gui_jump"]
        self._parent._cache.clear()

    def get_number_of_jumps(self) -> int:
        return len(self.config["jumps"])

    def jump_params_to_flags(self, toas) -> None:
        """Stamp ``-jump <i>`` (i counting the jumps from 1) on the TOAs
        each jump selects (host TOAs, or a batch frozen from them)."""
        from pint_torch.models.timing_model import _host_of
        from pint_torch.toa import select_toa_mask

        host = _host_of(toas)
        table = self._parent.params_table
        for i, j in enumerate(self.config["jumps"]):
            for k in select_toa_mask(table[j], host):
                host.flags[k]["jump"] = str(i + 1)



class DelayJump(DelayComponent):
    """Tempo-style delay jumps (reference ``jump.py:118-147``): delay
    -JUMP [s] on the selected TOAs.  Config: ``jumps``; context:
    ``masks`` {name: (N,)}."""

    register = True
    category = "jump_delay"

    def declare(self):
        self.add_param(maskParameter("JUMP", index=1, units="s", value=0.0,
                                     description="Delay jump (seconds)"))

    setup = PhaseJump.setup

    def host_context(self, toas):
        return {"masks": self._select_masks(toas,
                                            self.config.get("jumps", []))}

    def delay_func(self, pv, batch, ctx, acc_delay):
        d = torch.zeros_like(batch.freq)
        for j in self.config.get("jumps", []):
            d = d - pv.get(j, 0.0) * ctx["masks"][j]
        return d
