"""Native FITS binary-table reader, tested against a hand-built
standard-conforming FITS file (astropy is not available here)."""

import numpy as np

from gpy_dla_detection_tpu.data.fits import (
    _block,
    _card,
    read_fits_tables,
    read_spec,
    write_speclite as _write_speclite,
)


def test_read_fits_tables_roundtrip(tmp_path):
    n = 500
    rng = np.random.default_rng(0)
    flux = rng.normal(size=n).astype(np.float32)
    loglam = (np.log10(3600.0) + 1e-4 * np.arange(n)).astype(np.float32)
    ivar = rng.uniform(0, 10, size=n).astype(np.float32)
    ivar[::50] = 0.0
    and_mask = np.zeros(n, np.int32)
    and_mask[::70] = 1 << 24  # BRIGHTSKY

    path = str(tmp_path / "spec-1234-55555-0001.fits")
    _write_speclite(path, flux, loglam, ivar, and_mask)

    tables = read_fits_tables(path)
    assert tables[0]["name"].strip() == "COADD"
    np.testing.assert_allclose(tables[0]["columns"]["flux"], flux)

    wl, fx, nv, mask = read_spec(path)
    np.testing.assert_allclose(wl, 10.0 ** loglam.astype(np.float64), rtol=1e-6)
    np.testing.assert_allclose(fx, flux, rtol=1e-6)
    good = ivar != 0
    np.testing.assert_allclose(nv[good], 1.0 / ivar[good], rtol=1e-6)
    assert np.all(np.isnan(nv[~good]))
    want_mask = (~good) | (and_mask >> 24 & 1).astype(bool)
    assert np.array_equal(mask, want_mask)


def test_pcount_heap_does_not_misalign_following_hdus(tmp_path):
    """A BINTABLE with PCOUNT heap bytes (variable-length arrays) must
    not shift the parse of subsequent HDUs (FITS 4.0 section 7.3.2)."""
    n = 8
    rec = np.zeros(n, dtype=[("a", ">f4")])
    rec["a"] = np.arange(n)
    data = rec.tobytes()
    heap = b"\x7f" * 100  # heap area after the fixed table
    pad = (-(len(data) + len(heap))) % 2880

    first = _block(
        [
            _card("XTENSION", "BINTABLE"),
            _card("BITPIX", 8), _card("NAXIS", 2),
            _card("NAXIS1", 4), _card("NAXIS2", n),
            _card("PCOUNT", len(heap)), _card("GCOUNT", 1),
            _card("TFIELDS", 1),
            _card("TTYPE1", "a"), _card("TFORM1", "E"),
            _card("EXTNAME", "FIRST"),
        ]
    )
    rec2 = np.zeros(3, dtype=[("b", ">i4")])
    rec2["b"] = [7, 8, 9]
    data2 = rec2.tobytes()
    second = _block(
        [
            _card("XTENSION", "BINTABLE"),
            _card("BITPIX", 8), _card("NAXIS", 2),
            _card("NAXIS1", 4), _card("NAXIS2", 3),
            _card("PCOUNT", 0), _card("GCOUNT", 1),
            _card("TFIELDS", 1),
            _card("TTYPE1", "b"), _card("TFORM1", "J"),
            _card("EXTNAME", "SECOND"),
        ]
    )
    path = str(tmp_path / "heap.fits")
    with open(path, "wb") as f:
        f.write(_block([_card("SIMPLE", True), _card("BITPIX", 8), _card("NAXIS", 0)]))
        f.write(first)
        f.write(data + heap + b"\x00" * pad)
        f.write(second)
        f.write(data2 + b"\x00" * ((-len(data2)) % 2880))

    tables = read_fits_tables(path)
    assert [t["name"] for t in tables] == ["FIRST", "SECOND"]
    np.testing.assert_array_equal(tables[1]["columns"]["b"], [7, 8, 9])


def test_malformed_files_raise_cleanly(tmp_path):
    """Corrupt inputs raise (the survey driver captures them per
    spectrum) instead of crashing the process or looping."""
    import pytest

    not_fits = str(tmp_path / "x.fits")
    with open(not_fits, "wb") as f:
        f.write(b"definitely not a fits file")
    with pytest.raises(ValueError, match="truncated|not a FITS"):
        read_fits_tables(not_fits)

    empty = str(tmp_path / "empty.fits")
    open(empty, "wb").close()
    with pytest.raises(ValueError, match="not a FITS"):
        read_fits_tables(empty)

    # header claims more rows than the file carries
    truncated = str(tmp_path / "trunc.fits")
    with open(truncated, "wb") as f:
        f.write(_block([_card("SIMPLE", True), _card("BITPIX", 8), _card("NAXIS", 0)]))
        f.write(_block(
            [
                _card("XTENSION", "BINTABLE"),
                _card("BITPIX", 8), _card("NAXIS", 2),
                _card("NAXIS1", 4), _card("NAXIS2", 100000),
                _card("PCOUNT", 0), _card("GCOUNT", 1),
                _card("TFIELDS", 1),
                _card("TTYPE1", "a"), _card("TFORM1", "E"),
            ]
        ))
        f.write(b"\x00" * 64)
    with pytest.raises(ValueError):
        read_fits_tables(truncated)


def test_spec_url_releases():
    """URL construction per release (reference: read_spec.py:138-185)."""
    import pytest

    from gpy_dla_detection_tpu.data.download import spec_url

    # ordinary dr12q plate -> v5_7_0 BOSS redux
    assert spec_url(5309, 55929, 362) == (
        "https://data.sdss.org/sas/dr12/boss/spectro/redux/v5_7_0/"
        "spectra/lite/5309/spec-5309-55929-0362.fits"
    )
    # one of the 33 late plates -> v5_7_2
    assert "/v5_7_2/" in spec_url(7339, 56000, 1)
    # dr14q -> v5_13_0 eBOSS redux under DR16 (reference: read_spec.py:180-183)
    assert spec_url(7596, 56945, 838, release="dr14q") == (
        "https://data.sdss.org/sas/dr16/eboss/spectro/redux/v5_13_0/"
        "spectra/lite/7596/spec-7596-56945-0838.fits"
    )
    with pytest.raises(ValueError, match="dr12q or dr14q"):
        spec_url(1, 2, 3, release="dr16q")


def test_read_spec_dr14q_first_extension(tmp_path):
    """DR14Q files carry the coadd in the first (unnamed) extension;
    the dr14q reader must not require a COADD EXTNAME
    (reference: read_spec.py:74-120)."""
    from gpy_dla_detection_tpu.data.fits import read_spec_dr14q, spec_reader

    n = 64
    rng = np.random.default_rng(1)
    flux = rng.normal(size=n).astype(np.float32)
    loglam = (np.log10(3600.0) + 1e-4 * np.arange(n)).astype(np.float32)
    ivar = rng.uniform(0.5, 10, size=n).astype(np.float32)
    ivar[::9] = 0.0
    and_mask = np.zeros(n, np.int32)
    and_mask[::11] = 1 << 24

    path = str(tmp_path / "spec-7596-56945-0838.fits")
    _write_speclite(path, flux, loglam, ivar, and_mask)
    # strip the EXTNAME card so the table is anonymous like dr14q coadds
    raw = open(path, "rb").read().replace(b"EXTNAME = 'COADD", b"COMMENT = 'COADD")
    open(path, "wb").write(raw)

    wl, fx, nv, mask = read_spec_dr14q(path)
    np.testing.assert_allclose(fx, flux, rtol=1e-6)
    good = ivar != 0
    np.testing.assert_allclose(nv[good], 1.0 / ivar[good], rtol=1e-6)
    assert np.all(np.isnan(nv[~good]))
    assert np.array_equal(mask, (~good) | (and_mask >> 24 & 1).astype(bool))

    assert spec_reader("dr12q") is read_spec
    assert spec_reader("dr14q") is read_spec_dr14q


def test_image_extension_and_exotic_columns(tmp_path):
    """A float IMAGE extension before the table must not misalign the
    parse (its data size is |BITPIX|/8 x prod NAXISn, not
    NAXIS1*NAXIS2), logical columns decode to booleans (raw 'T'/'F'
    bytes are both truthy), and an opaque bit-array column is skipped
    without aborting the read (FITS 4.0 sections 7.1, 7.3)."""
    img = np.arange(200, dtype=">f4").reshape(10, 20)
    img_bytes = img.tobytes()
    image_hdu = _block(
        [
            _card("XTENSION", "IMAGE"),
            _card("BITPIX", -32), _card("NAXIS", 2),
            _card("NAXIS1", 20), _card("NAXIS2", 10),
            _card("PCOUNT", 0), _card("GCOUNT", 1),
        ]
    ) + img_bytes + b"\x00" * ((-len(img_bytes)) % 2880)

    n = 6
    rec = np.zeros(n, dtype=[("flag", "u1"), ("bits", "u1"), ("val", ">f4")])
    rec["flag"] = [ord(c) for c in "TFTFTT"]  # FITS logicals
    rec["bits"] = 0xAA  # opaque 8-bit X column
    rec["val"] = np.arange(n)
    data = rec.tobytes()
    table_hdu = _block(
        [
            _card("XTENSION", "BINTABLE"),
            _card("BITPIX", 8), _card("NAXIS", 2),
            _card("NAXIS1", rec.dtype.itemsize), _card("NAXIS2", n),
            _card("PCOUNT", 0), _card("GCOUNT", 1),
            _card("TFIELDS", 3),
            _card("TTYPE1", "flag"), _card("TFORM1", "L"),
            _card("TTYPE2", "bits"), _card("TFORM2", "8X"),
            _card("TTYPE3", "val"), _card("TFORM3", "E"),
            _card("EXTNAME", "TAB"),
        ]
    ) + data + b"\x00" * ((-len(data)) % 2880)

    path = str(tmp_path / "exotic.fits")
    with open(path, "wb") as f:
        f.write(_block([_card("SIMPLE", True), _card("BITPIX", 8), _card("NAXIS", 0)]))
        f.write(image_hdu)
        f.write(table_hdu)

    tables = read_fits_tables(path)
    assert len(tables) == 1 and tables[0]["name"].strip() == "TAB"
    cols = tables[0]["columns"]
    assert "bits" not in cols  # opaque column skipped, not fatal
    assert cols["flag"].dtype == bool
    assert list(cols["flag"]) == [True, False, True, False, True, True]
    np.testing.assert_allclose(cols["val"], np.arange(n))
