"""The port's readers and writers (dinox_torch.data.dicom, .nifti, .hu)
against the JAX package's: files written by JAX's writers read by the
port's readers and files written by the port's writers read by JAX's, with
arrays bit-equal and spacing and tags equal; the compressed-syntax error's
message and stop_before_pixels; hand-built NIfTI headers (int16 with
scl_slope/scl_inter, big-endian, gzip); and encode_hu16, decode_hu16 and
window bit-equal to JAX's."""

import struct

import numpy as np
import pytest

from dinox_torch.data import dicom as t_dicom
from dinox_torch.data import hu as t_hu
from dinox_torch.data import nifti as t_nifti
from dinox_tpu.data import dicom as j_dicom
from dinox_tpu.data import hu as j_hu
from dinox_tpu.data import nifti as j_nifti

DICOM_TAGS = ("series_uid", "patient_id", "pixel_spacing", "slice_thickness", "image_position_z",
              "rescale")


def _dicom_kw(seed):
    rng = np.random.default_rng(seed)
    return dict(series_uid=f"1.2.840.{seed}9", patient_id=f"P{seed}",
                pixel_spacing=(float(rng.uniform(0.4, 1.0)), float(rng.uniform(0.4, 1.0))),
                slice_thickness=2.5, position_z=-37.5 + seed, rescale_slope=1.0 + seed % 2,
                rescale_intercept=-1024.0)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("shape", [(32, 24), (17, 9)])
def test_dicom_across_packages(tmp_path, writer, shape):
    px = np.random.default_rng(1).integers(-1000, 3000, shape).astype(np.int16)
    kw = _dicom_kw(len(shape) + shape[1])
    p = tmp_path / "s.dcm"
    (j_dicom if writer == "jax" else t_dicom).write_dicom(p, px, **kw)
    if writer == "port":  # the same file, byte for byte
        q = tmp_path / "j.dcm"
        j_dicom.write_dicom(q, px, **kw)
        assert p.read_bytes() == q.read_bytes()
    got, want = t_dicom.read_dicom(p), j_dicom.read_dicom(p)
    assert got.elements == want.elements
    for tag in DICOM_TAGS:
        assert getattr(got, tag) == getattr(want, tag), tag
    assert got.pixel_array.dtype == want.pixel_array.dtype == np.int16
    np.testing.assert_array_equal(got.pixel_array, px)
    np.testing.assert_array_equal(got.hu(), want.hu())
    assert got.pixel_spacing == pytest.approx(kw["pixel_spacing"])


def test_dicom_implicit_vr(tmp_path):
    """An implicit-VR LE dataset with no preamble (both readers guess
    implicit LE): the same elements and pixels."""
    px = np.arange(12, dtype="<u2").reshape(3, 4)

    def elem(tag, value):
        return struct.pack("<HHI", *tag, len(value)) + value

    raw = b"".join([elem(t_dicom.TAG_SERIES_UID, b"1.5\x00"), elem(t_dicom.TAG_ROWS, struct.pack("<H", 3)),
                    elem(t_dicom.TAG_COLS, struct.pack("<H", 4)),
                    elem(t_dicom.TAG_RESCALE_SLOPE, b"2 "), elem(t_dicom.TAG_PIXEL_DATA, px.tobytes())])
    p = tmp_path / "implicit.dcm"
    p.write_bytes(raw)
    got, want = t_dicom.read_dicom(p), j_dicom.read_dicom(p)
    assert got.elements == want.elements and got.series_uid == "1.5"
    np.testing.assert_array_equal(got.pixel_array, px)
    np.testing.assert_array_equal(got.hu(), want.hu())
    assert got.rescale == (2.0, 0.0)


def test_dicom_stop_before_pixels(tmp_path):
    p = tmp_path / "s.dcm"
    t_dicom.write_dicom(p, np.zeros((8, 8), np.int16), pixel_spacing=(0.6, 0.9))
    ds = t_dicom.read_dicom(p, stop_before_pixels=True)
    assert ds.pixel_array is None and ds.pixel_spacing == pytest.approx((0.6, 0.9))
    assert ds.elements == j_dicom.read_dicom(p, stop_before_pixels=True).elements
    with pytest.raises(ValueError, match="stop_before_pixels"):
        ds.hu()


@pytest.mark.parametrize("uid,name", [(b"1.2.840.10008.1.2.5\x00", "RLE Lossless"),
                                      (b"1.2.840.10008.1.2.2\x00", "Explicit VR Big Endian")])
def test_dicom_rejects_compressed_syntax_as_jax_does(tmp_path, uid, name):
    p = tmp_path / "s.dcm"
    t_dicom.write_dicom(p, np.zeros((4, 4), np.int16))
    p.write_bytes(p.read_bytes().replace(b"1.2.840.10008.1.2.1\x00", uid))
    with pytest.raises(t_dicom.UnsupportedTransferSyntaxError) as got:
        t_dicom.read_dicom(p)
    with pytest.raises(j_dicom.UnsupportedTransferSyntaxError) as want:
        j_dicom.read_dicom(p)
    assert str(got.value) == str(want.value) and f"({name})" in str(got.value)
    assert isinstance(got.value, ValueError)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("suffix", [".nii.gz", ".nii"])
def test_nifti_across_packages(tmp_path, writer, suffix):
    vol = np.random.default_rng(0).normal(0, 300, (16, 20, 6)).astype(np.float32)
    p = tmp_path / f"x{suffix}"
    (j_nifti if writer == "jax" else t_nifti).write_nifti(p, vol, spacing=(0.7, 0.8, 2.5))
    got, want = t_nifti.read_nifti(p), j_nifti.read_nifti(p)
    assert got.data.dtype == want.data.dtype == np.float32
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.data, vol)
    assert got.spacing == want.spacing == pytest.approx((0.7, 0.8, 2.5))
    assert got.n_slices == want.n_slices == 6
    for z in range(6):
        np.testing.assert_array_equal(got.slice_hu(z), want.slice_hu(z))
    np.testing.assert_array_equal(got.slice_hu(2), vol[:, :, 2].T)


@pytest.mark.parametrize("endian", ["<", ">"])
def test_nifti_int16_scl_headers(tmp_path, endian):
    """Hand-built int16 headers with scl_slope/scl_inter, little- and
    big-endian, plain and 4-D (the first volume is read)."""
    data = np.arange(48, dtype=endian + "i2").reshape(2, 3, 4, 2, order="F")
    hdr = bytearray(348)
    struct.pack_into(endian + "i", hdr, 0, 348)
    struct.pack_into(endian + "8h", hdr, 40, 4, 2, 3, 4, 2, 1, 1, 1)
    struct.pack_into(endian + "2h", hdr, 70, 4, 16)
    struct.pack_into(endian + "8f", hdr, 76, 0, -1.5, 1.5, 3.0, 0, 0, 0, 0)
    struct.pack_into(endian + "f", hdr, 108, 352.0)
    struct.pack_into(endian + "2f", hdr, 112, 2.0, -10.0)
    hdr[344:348] = b"n+1\x00"
    p = tmp_path / "golden.nii"
    p.write_bytes(bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F"))
    got, want = t_nifti.read_nifti(p), j_nifti.read_nifti(p)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.data, data.astype(np.float32) * 2.0 - 10.0)
    assert got.spacing == want.spacing == (1.5, 1.5, 3.0)
    np.testing.assert_array_equal(got.slice_hu(1), want.slice_hu(1))


def test_nifti_rejects_garbage(tmp_path):
    p = tmp_path / "bad.nii"
    p.write_bytes(b"\x00" * 400)
    with pytest.raises(ValueError, match="sizeof_hdr"):
        t_nifti.read_nifti(p)
    p.write_bytes(b"\x00" * 10)
    with pytest.raises(ValueError, match="too short"):
        t_nifti.read_nifti(p)


def test_hu_helpers_bit_equal():
    hu = np.random.default_rng(3).normal(0, 2000, (64, 64)) * np.float32(1.7)
    hu[0, :4] = [-1e6, 1e6, 0.5, -0.5]
    enc = t_hu.encode_hu16(hu)
    assert enc.dtype == np.uint16
    np.testing.assert_array_equal(enc, j_hu.encode_hu16(hu))
    np.testing.assert_array_equal(t_hu.decode_hu16(enc), j_hu.decode_hu16(enc))
    d = t_hu.decode_hu16(enc)
    for level, width in ((40.0, 400.0), (-600.0, 1500.0), (0.0, 0.5)):
        np.testing.assert_array_equal(t_hu.window(d, level, width), j_hu.window(d, level, width))
