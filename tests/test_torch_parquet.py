"""The port's Parquet codec (dinox_torch.zoo._parquet) and DataManifest
against pyarrow and the JAX package's DataManifest: each test writes one way
and reads the other. pyarrow's defaults (snappy, dictionary pages, the PLAIN
fallback past the dictionary limit, several pages, several row groups) read
back unchanged through the port; the port's PLAIN, uncompressed files read
back unchanged through pyarrow and the JAX manifest; data page v2 and other
codecs raise."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from dinox_torch.zoo import _parquet
from dinox_torch.zoo import schemas as t_schemas
from dinox_torch.zoo.manifest import SCHEMA
from dinox_torch.zoo.manifest import DataManifest as TManifest
from dinox_tpu.zoo import schemas as j_schemas
from dinox_tpu.zoo.manifest import _SCHEMA as JAX_SCHEMA
from dinox_tpu.zoo.manifest import DataManifest as JManifest


def slice_dicts(n, seed=0, long_paths=False):
    """Manifest rows with None ids, empty and several organs and unicode."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        path = (f"/data/processed/séries_{i:06d}/" + "long_path_segment/" * 4 + f"{i:08d}.png"
                if long_paths else f"ds/s{i // 9}/{i % 9:04d}_é.png")
        rows.append(dict(
            dataset=["lidc-idri", "pancreas-ct", "cq500"][i % 3], series_id=f"s{i // 9}", slice_idx=i % 9,
            pixel_spacing_x=float(rng.uniform(0.3, 1.0)), pixel_spacing_y=float(rng.uniform(0.3, 1.0)),
            slice_thickness=float(rng.choice([0.625, 1.0, 5.0])), image_path=path,
            organs_present=[[], ["lung"], ["liver", "hepatic_vessels", "肝"]][i % 3],
            patient_id=None if i % 2 else f"LIDC-{i:04d}", study_date=None if i % 4 else "2011-01-01"))
    return rows


def _dumps(m):
    return [r.model_dump() for r in m.records]


def _jax(rows):
    return JManifest([j_schemas.SliceMetadata(**r) for r in rows])


def _port(rows):
    return TManifest([t_schemas.SliceMetadata(**r) for r in rows])


def test_schema_matches_the_jax_manifest():
    assert [name for name, _ in SCHEMA] == JAX_SCHEMA.names


@pytest.mark.parametrize("n", [0, 1, 37])
def test_jax_save_reads_back_through_the_port(tmp_path, n):
    rows = slice_dicts(n)
    _jax(rows).save(tmp_path / "m.parquet")
    assert _dumps(TManifest.load(tmp_path / "m.parquet")) == _dumps(_jax(rows)) == rows


@pytest.mark.parametrize("n", [0, 1, 37])
def test_port_save_reads_back_through_pyarrow_and_jax(tmp_path, n):
    rows = slice_dicts(n)
    _port(rows).save(tmp_path / "m.parquet")
    table = pq.read_table(tmp_path / "m.parquet")
    assert table.column_names == JAX_SCHEMA.names and table.num_rows == n
    assert table.to_pylist() == rows
    assert _dumps(JManifest.load(tmp_path / "m.parquet")) == rows
    assert _dumps(TManifest.load(tmp_path / "m.parquet")) == rows


def _page_encodings(path, column):
    """{(page type, encoding)} of a column chunk's pages, from the footer's
    encoding stats, and the number of its data pages."""
    buf = path.read_bytes()
    n = int.from_bytes(buf[-8:-4], "little")
    meta = _parquet._ThriftReader(buf, len(buf) - 8 - n).struct()
    names = [el[4].decode() for el in meta[2][1:]]
    chunk = meta[4][0][1][names.index(column)][3]
    stats = chunk[13]
    return {(s[1], s[2]) for s in stats}, sum(s[3] for s in stats if s[1] == _parquet.DATA_PAGE)


def test_dictionary_fallback_and_many_pages(tmp_path):
    """20000 unique ~100-byte paths pass pyarrow's 1 MB dictionary limit: the
    chunk holds dictionary-encoded pages, then PLAIN ones."""
    rows = slice_dicts(20000, seed=1, long_paths=True)
    path = tmp_path / "m.parquet"
    _jax(rows).save(path)
    pages, n_data = _page_encodings(path, "image_path")
    assert (_parquet.DATA_PAGE, _parquet.RLE_DICTIONARY) in pages
    assert (_parquet.DATA_PAGE, _parquet.PLAIN) in pages and n_data > 2
    assert _dumps(TManifest.load(path)) == rows
    _port(rows).save(tmp_path / "port.parquet")
    assert pq.read_table(tmp_path / "port.parquet").to_pylist() == rows


def test_several_row_groups_nulls_and_empty_lists(tmp_path):
    rows = slice_dicts(300, seed=2)
    for i in range(0, 300, 7):
        rows[i]["organs_present"] = None  # a null list, not an empty one
    for i in range(3, 300, 11):
        rows[i]["organs_present"] = ["lung", None]  # a null element
    for i in range(5, 300, 13):
        rows[i]["pixel_spacing_x"] = rows[i]["slice_idx"] = None
    table = pa.Table.from_pylist(rows, schema=JAX_SCHEMA)
    path = tmp_path / "t.parquet"
    pq.write_table(table, path, row_group_size=64)
    assert pq.ParquetFile(path).metadata.num_row_groups == 5
    names, got = _parquet.read_table(path)
    assert names == JAX_SCHEMA.names and got == table.to_pylist()
    pq.write_table(table, path, use_dictionary=False, compression="none", data_page_size=512)
    assert _parquet.read_table(path)[1] == table.to_pylist()
    _parquet.write_table(tmp_path / "port.parquet", SCHEMA, rows)
    assert pq.read_table(tmp_path / "port.parquet").to_pylist() == table.to_pylist()


@pytest.mark.parametrize("kw,match", [(dict(data_page_version="2.0"), "data page v2"),
                                      (dict(compression="gzip"), "GZIP"),
                                      (dict(compression="zstd"), "ZSTD")])
def test_unsupported_pages_and_codecs_raise(tmp_path, kw, match):
    path = tmp_path / "m.parquet"
    pq.write_table(pa.Table.from_pylist(slice_dicts(5), schema=JAX_SCHEMA), path, **kw)
    with pytest.raises(ValueError, match=match):
        TManifest.load(path)


def test_snappy_copies_that_overlap_their_output():
    # "ab", then a 2-byte-offset copy of 10 bytes (overlapping), a 1-byte-
    # offset copy of 4 bytes from offset 1, and a literal.
    block = bytes([17, 1 << 2]) + b"ab" + bytes([(9 << 2) | 2, 2, 0]) + bytes([(0 << 2) | 1, 1]) + bytes([0]) + b"z"
    assert _parquet.snappy_decompress(block) == b"ab" + b"ababababab" + b"bbbb" + b"z"
    with pytest.raises(ValueError):
        _parquet.snappy_decompress(bytes([5, 1 << 2]) + b"ab" + bytes([(9 << 2) | 2, 9, 0]))


def test_hybrid_levels_round_trip():
    rng = np.random.default_rng(0)
    for width in (1, 2, 3, 7):
        vals = rng.integers(0, 1 << width, 1001)
        buf = _parquet.encode_hybrid(vals, width)
        np.testing.assert_array_equal(_parquet.decode_hybrid(buf, 0, len(buf), width, len(vals)), vals)
    run = _parquet._varint(9 << 1) + bytes([5])  # an RLE run of nine 5s at width 3
    np.testing.assert_array_equal(_parquet.decode_hybrid(run, 0, len(run), 3, 9), [5] * 9)
