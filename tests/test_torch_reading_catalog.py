"""The catalogue's ``(par, tim)`` entries: a small synthetic catalogue
(the reference's ``make_synthetic_catalog``, one member with a corrupt
row) written to files with the reference's writers, then ingested by both
packages from those files: the ingest report, each member's certified
TOAs and quarantine codes, the shape buckets and their padding waste
exactly the reference's."""

from __future__ import annotations

import numpy as np
import pytest

from pint_torch.catalog import assign_buckets, ingest_catalog, learn_ladders
from pint_tpu.catalog import assign_buckets as ref_assign
from pint_tpu.catalog import ingest_catalog as ref_ingest
from pint_tpu.catalog import learn_ladders as ref_learn
from pint_tpu.catalog.ingest import make_synthetic_catalog


@pytest.fixture
def lenient():
    """Both packages' process-wide ingestion policy lenient for the test
    (``get_TOAs`` reads it, as the reference's catalogue does)."""
    from pint_torch import config
    from pint_tpu import config as ref_config

    before = (config.ingestion_policy(), ref_config.ingestion_policy())
    config.set_ingestion_policy("lenient")
    ref_config.set_ingestion_policy("lenient")
    yield
    config.set_ingestion_policy(before[0])
    ref_config.set_ingestion_policy(before[1])


def test_catalogue_from_files_is_the_references(tmp_path, lenient):
    members = make_synthetic_catalog(n_pulsars=3, seed=23,
                                     ntoa_range=(24, 40), bad_rows_in=[1])
    pairs = []
    for i, (model, toas) in enumerate(members):
        par, tim = tmp_path / f"m{i}.par", tmp_path / f"m{i}.tim"
        par.write_text(model.as_parfile())
        toas.write_TOA_file(str(tim))
        pairs.append((str(par), str(tim)))
    rep = ingest_catalog(pairs, device="cpu")
    ref = ref_ingest(pairs)
    assert rep.to_dict() == ref.to_dict()
    assert rep.render() == ref.render()
    assert rep.n_quarantined == 1 and rep.codes() == ["toa-bad-error"]
    for p, r in zip(rep.pulsars, ref.pulsars):
        assert (p.name, p.n_toas, p.n_free, p.n_quarantined,
                p.quarantine_codes) == (r.name, r.n_toas, r.n_free,
                                        r.n_quarantined, r.quarantine_codes)
        rb = r.toas.to_batch()
        assert np.array_equal(p.toas.tdb.hi.numpy(), np.asarray(rb.tdb.hi))
        assert np.array_equal(p.toas.tdb_s.lo.numpy(),
                              np.asarray(rb.tdb_s.lo))
        assert np.array_equal(p.toas.error_us.numpy(),
                              np.asarray(rb.error_us))
    shapes = [p.shape() for p in rep.pulsars]
    assert shapes == [r.shape() for r in ref.pulsars]
    lad = learn_ladders(shapes, pad_budget=0.25, max_rungs=3)
    assert lad == ref_learn(shapes, pad_budget=0.25, max_rungs=3)
    got, want = assign_buckets(shapes, *lad), ref_assign(shapes, *lad,
                                                         emit=False)
    assert got.buckets == want.buckets
    assert got.pad_waste_frac == want.pad_waste_frac
