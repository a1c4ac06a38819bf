"""Columnar substrate: Arrow tables <-> column batches of tensors.

A batch holds one array per column, in one of two residences:
- the HOST lane: numpy arrays (the adaptive lane for small reads, where a
  device round-trip would dominate the work);
- the DEVICE lane: torch tensors on one device (the CUDA card; the CPU
  when the caller asks for it, as the CPU tests do).

Strings are dictionary-encoded on the host with a *sorted* dictionary so
int32 codes are order-preserving (sort/compare on codes == lexicographic on
values), and each dictionary entry carries a precomputed 64-bit value hash
(FNV-1a over the UTF-8 bytes), so bucket assignment hashes the *value*
(stable across files/batches with different dictionaries), never the code.
On the device lane the hash halves are int64 tensors holding the uint32
values (`ops/keys.py` lane convention).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.plan.schema import Field as SchemaField, Schema
from hyperspace_tpu_torch.telemetry.compilation import instrumented_device

_NUMERIC_NP = {
    "bool": np.bool_,
    "int8": np.int8, "int16": np.int16, "int32": np.int32, "int64": np.int64,
    "float32": np.float32, "float64": np.float64,
    "date32": np.int32, "timestamp": np.int64,
}

# Logical dtype -> host numpy dtype, incl. the string code representation.
HOST_NP_DTYPES = {**_NUMERIC_NP, "string": np.int32}


def _string_hash64(values: np.ndarray) -> np.ndarray:
    """FNV-1a 64-bit over the UTF-8 bytes of each value (host side, once
    per dictionary entry — O(dictionary), not O(rows)). Uses the native
    C++ batch hash when the library loads (`hyperspace_tpu_torch/native`);
    the Python loop below is the reference implementation and fallback.
    Both must equal the JAX package's hashes bit for bit: the bucket
    layout depends on them."""
    if len(values) >= 64:
        from hyperspace_tpu_torch import native
        hashed = native.string_hash64(values)
        if hashed is not None:
            return hashed
    return string_hash64_python(values)


def string_hash64_python(values: np.ndarray) -> np.ndarray:
    """The pure-Python FNV-1a 64 loop: `_string_hash64`'s reference
    implementation and its fallback when the native library is absent."""
    out = np.empty(len(values), dtype=np.uint64)
    for i, v in enumerate(values):
        h = 0xCBF29CE484222325
        for b in str(v).encode("utf-8"):
            h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        out[i] = h
    return out


def _split_hashes(hashes: np.ndarray,
                  device: Optional[torch.device] = None):
    """uint64 value hashes -> (hi, lo) uint32 pair: numpy uint32 on the
    host lane, zero-extended int64 tensors on `device`."""
    hi = (hashes >> np.uint64(32)).astype(np.uint32)
    lo = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if device is None:
        return hi, lo
    return (torch.from_numpy(hi.astype(np.int64)).to(device),
            torch.from_numpy(lo.astype(np.int64)).to(device))


def _to_device(arr: Optional[np.ndarray], device: torch.device):
    """A host array as a tensor on `device`, never aliasing read-only
    (Arrow-owned) host memory: a CPU device gets a copy of such an array;
    a CUDA device reads it once, in the host-to-device copy."""
    if arr is None:
        return None
    arr = np.ascontiguousarray(arr)
    if arr.flags.writeable:
        return torch.from_numpy(arr).to(device)
    if device.type == "cpu":
        return torch.from_numpy(arr.copy())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr).to(device)


@dataclass
class DeviceColumn:
    """One column.

    `data`: numpy array (host lane) or torch tensor (device lane) —
    numeric payload, or int32 dictionary codes for strings. `validity`:
    optional bool array of the same residence (True = present).
    `dictionary`: host numpy array of unique values, sorted ascending, for
    string columns. `dict_hashes`: (hi, lo) per dictionary entry — value
    hashes for bucket assignment, in the column's residence.
    """

    data: object
    dtype: str
    validity: Optional[object] = None
    dictionary: Optional[np.ndarray] = None
    dict_hashes: Optional[object] = None

    @property
    def is_string(self) -> bool:
        return self.dictionary is not None

    @property
    def is_host(self) -> bool:
        """True when the payload lives in host memory (numpy)."""
        return isinstance(self.data, np.ndarray)

    def __len__(self) -> int:
        return int(self.data.shape[0])


@dataclass
class ColumnBatch:
    """A batch of columns (same length), with its logical schema."""

    schema: Schema
    columns: Dict[str, DeviceColumn]

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    def column(self, name: str) -> DeviceColumn:
        f = self.schema.field(name)  # case-insensitive resolve + validation
        return self.columns[f.name]

    def select(self, names: Sequence[str]) -> "ColumnBatch":
        schema = self.schema.select(names)
        return ColumnBatch(schema, {f.name: self.columns[f.name]
                                    for f in schema.fields})

    @property
    def is_host(self) -> bool:
        return all(c.is_host for c in self.columns.values())

    @property
    def device(self) -> Optional[torch.device]:
        """The device of the batch's tensors; None on the host lane."""
        for c in self.columns.values():
            if not c.is_host:
                # A fused stage's deferred build column names its device
                # without gathering (`engine/fusion._LazyGatherColumn`).
                return getattr(c, "device", None) or c.data.device
        return None

    def take(self, indices) -> "ColumnBatch":
        """Row gather by index array: numpy indices gather a host batch
        on the host; tensor indices gather a device batch on its
        device, every device column in one `fused_take` call."""
        out = {}
        device_cols = [name for name, col in self.columns.items()
                       if not col.is_host]
        gathered = {}
        if device_cols:
            device = self.columns[device_cols[0]].data.device
            arrays = []
            for name in device_cols:
                col = self.columns[name]
                arrays.append(col.data)
                if col.validity is not None:
                    arrays.append(col.validity)
            taken = iter(fused_take(
                arrays, torch.as_tensor(indices, device=device)))
            for name in device_cols:
                data = next(taken)
                validity = (next(taken) if self.columns[name].validity
                            is not None else None)
                gathered[name] = (data, validity)
        for name, col in self.columns.items():
            if col.is_host:
                idx = np.asarray(indices)
                data = np.take(col.data, idx, axis=0)
                validity = (np.take(col.validity, idx, axis=0)
                            if col.validity is not None else None)
            else:
                data, validity = gathered[name]
            out[name] = DeviceColumn(data=data, dtype=col.dtype,
                                     validity=validity,
                                     dictionary=col.dictionary,
                                     dict_hashes=col.dict_hashes)
        return ColumnBatch(self.schema, out)


def _fused_take_cost(arrays, idx):
    """Modeled (operations, bytes accessed) of one gather: the index
    read once, and each gathered row of each array read once and
    written once; no arithmetic."""
    m = int(idx.numel())
    return 0, m * idx.element_size() + sum(
        2 * m * a.element_size() * int(np.prod(a.shape[1:]))
        for a in arrays)


def _fused_take(arrays, idx):
    return [a[idx] for a in arrays]


# Every device column's row gather (data and validity) as ONE entry point
# of the device seam — the JAX package's jitted `columnar.fused_take`.
fused_take = instrumented_device("columnar.fused_take", _fused_take,
                                 cost=_fused_take_cost)


def _encode_strings_arrow(arr):
    """Arrow-native sorted-dictionary encode: dictionary_encode +
    dictionary sort + code remap all run in Arrow C++; the value hashes
    run once per dictionary entry. Returns
    (codes int32, dictionary np[str], hashes uint64, validity|None)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if hasattr(arr, "combine_chunks"):
        arr = arr.combine_chunks()
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.chunk(0) if arr.num_chunks == 1 else pa.concat_arrays(
            arr.chunks)
    if pa.types.is_dictionary(arr.type):
        # Incoming dictionaries may hold duplicates or nulls; decode and
        # re-encode so the sorted-unique invariants hold.
        arr = arr.cast(pa.string())
    validity = None
    if arr.null_count:
        validity = np.asarray(arr.is_valid())
        arr = arr.fill_null("")
    encoded = pc.dictionary_encode(arr)
    raw_dict = encoded.dictionary
    indices = encoded.indices.to_numpy(zero_copy_only=False).astype(np.int32)
    sort_idx = pc.sort_indices(raw_dict).to_numpy().astype(np.int32)
    rank = np.empty(len(raw_dict), dtype=np.int32)
    rank[sort_idx] = np.arange(len(raw_dict), dtype=np.int32)
    codes = rank[indices]
    sorted_dict = raw_dict.take(pa.array(sort_idx))
    from hyperspace_tpu_torch import native
    hashes = native.arrow_string_hash64(sorted_dict)
    dictionary = np.asarray(sorted_dict.to_numpy(zero_copy_only=False),
                            dtype=str)
    if hashes is None:
        hashes = _string_hash64(dictionary)
    return codes, dictionary, hashes, validity


def _decode_numeric(arr, f: SchemaField):
    """Decode one non-string Arrow column to its RAW host values + null
    mask (no cast to the logical dtype's numpy type yet — on the device
    lane the cast is the step the transfer engine performs into its
    staging buffers). Returns (np_vals, np_dtype, mask|None)."""
    np_dtype = _NUMERIC_NP.get(f.dtype)
    if np_dtype is None:
        raise HyperspaceException(f"Unsupported dtype: {f.dtype}")
    chunk = arr.combine_chunks() if hasattr(arr, "combine_chunks") else arr
    if f.dtype == "timestamp":
        np_vals = chunk.cast("int64").to_numpy(zero_copy_only=False)
    elif f.dtype == "date32":
        np_vals = chunk.cast("int32").to_numpy(zero_copy_only=False)
    else:
        np_vals = chunk.to_numpy(zero_copy_only=False)
    mask = None
    if chunk.null_count > 0:
        mask = ~np.asarray(chunk.is_null())
        np_vals = np.where(mask, np.nan_to_num(np_vals), 0)
    return np.asarray(np_vals), np_dtype, mask


def _decode_device_column(arr, f: SchemaField) -> dict:
    """Transfer-engine job body for one column (runs on the staging
    pool): decode to host form and name what must be placed. ndarray /
    HostCast values cross the link; Host(...) values stay host."""
    from hyperspace_tpu_torch.io import transfer

    if f.dtype == "string":
        codes, dictionary, hashes, validity = _encode_strings_arrow(arr)
        hi, lo = _split_hashes(hashes)
        return {"data": codes, "validity": validity,
                "dictionary": transfer.Host(dictionary),
                "hash_hi": transfer.HostCast(hi, np.int64),
                "hash_lo": transfer.HostCast(lo, np.int64)}
    np_vals, np_dtype, mask = _decode_numeric(arr, f)
    data = (np.ascontiguousarray(np_vals) if np_vals.dtype == np_dtype
            else transfer.HostCast(np_vals, np_dtype))
    return {"data": data, "validity": mask}


def _placed_column(f: SchemaField, entry: dict,
                   dictionary=None) -> DeviceColumn:
    """One DeviceColumn from a `put_group` result."""
    hashes = None
    if "hash_hi" in entry:
        hashes = (entry["hash_hi"], entry["hash_lo"])
    return DeviceColumn(data=entry["data"], dtype=f.dtype,
                        validity=entry.get("validity"),
                        dictionary=entry.get("dictionary", dictionary),
                        dict_hashes=hashes)


def from_arrow(table, schema: Optional[Schema] = None,
               device: Optional[torch.device] = None,
               transfer_tag: Optional[str] = None) -> ColumnBatch:
    """Arrow table -> ColumnBatch. Nulls become validity masks with
    sentinel-filled payloads (0 / empty string). `device=None` keeps the
    columns in host memory (numpy) for the adaptive host lane.

    A device path is THE scan-side H2D site and runs STREAMED through
    the pipelined transfer engine (`io/transfer.py`): column decodes run
    on the staging pool while earlier columns' copies are in flight,
    large columns ship as byte-budgeted chunks cast into reused staging
    buffers, and the whole batch lands as one chunk-counted transfer
    record in the link telemetry (`transfer_tag` names the lane, e.g.
    the segment cache's "fill")."""
    if schema is None:
        schema = Schema.from_arrow(table.schema)
    if device is not None:
        from functools import partial

        from hyperspace_tpu_torch.io import transfer

        jobs = [partial(_decode_device_column, table.column(f.name), f)
                for f in schema.fields]
        placed = transfer.get_engine().put_group(jobs, device=device,
                                                 tag=transfer_tag)
        return ColumnBatch(schema, {
            f.name: _placed_column(f, entry)
            for f, entry in zip(schema.fields, placed)})
    columns: Dict[str, DeviceColumn] = {}
    for f in schema.fields:
        arr = table.column(f.name)
        if f.dtype == "string":
            codes, dictionary, hashes, validity = _encode_strings_arrow(arr)
            data, hashes = np.asarray(codes), _split_hashes(hashes)
        else:
            np_vals, np_dtype, validity = _decode_numeric(arr, f)
            data = np_vals.astype(np_dtype, copy=False)
            hashes = dictionary = None
        columns[f.name] = DeviceColumn(data=data, dtype=f.dtype,
                                       validity=validity,
                                       dictionary=dictionary,
                                       dict_hashes=hashes)
    return ColumnBatch(schema, columns)


def _to_numpy(arr) -> Optional[np.ndarray]:
    if arr is None or isinstance(arr, np.ndarray):
        return arr
    return arr.cpu().numpy()


def _fetch_columns(batch: ColumnBatch):
    """(data, validity) numpy pairs for every column, name-keyed. Device
    arrays cross through the transfer engine: every column's copy is
    issued asynchronously first (prefetch), so the per-column fetches
    overlap on the link and land in the d2h telemetry."""
    from hyperspace_tpu_torch.io import transfer

    engine = transfer.get_engine()
    for col in batch.columns.values():
        engine.prefetch(col.data, *((col.validity,)
                                    if col.validity is not None else ()))
    return {name: (engine.fetch(col.data),
                   engine.fetch(col.validity)
                   if col.validity is not None else None)
            for name, col in batch.columns.items()}


def to_arrow(batch: ColumnBatch):
    """ColumnBatch -> Arrow table (decodes dictionary codes); device
    columns cross to the host here, through the transfer engine."""
    import pyarrow as pa

    fetched = _fetch_columns(batch)
    arrays = []
    names = []
    for f in batch.schema.fields:
        col = batch.columns[f.name]
        data, validity = fetched[f.name]
        mask = ~validity if validity is not None else None
        if col.is_string:
            arr = pa.array(col.dictionary[data], type=pa.string(), mask=mask)
        elif f.dtype in ("timestamp", "date32"):
            pa_type = Schema([f]).to_arrow().field(0).type
            arr = pa.array(data, mask=mask).cast(pa_type)
        else:
            arr = pa.array(data, mask=mask)
        arrays.append(arr)
        names.append(f.name)
    return pa.table(dict(zip(names, arrays)))


def _owned_host(arr: np.ndarray) -> np.ndarray:
    """An OWNING host copy of a fetched array: a CPU tensor's array is a
    view of the tensor's memory, and a demoted cache entry built from
    views would keep the "evicted" storage alive. An array that already
    owns its memory passes through uncopied."""
    return np.array(arr, copy=True) if arr.base is not None else arr


def batch_to_host(batch: ColumnBatch) -> ColumnBatch:
    """Device ColumnBatch -> fully host-resident copy (numpy payloads,
    numpy uint32 dict hashes) — the segment cache's DEMOTION form:
    everything needed to rebuild the device batch WITHOUT re-reading or
    re-decoding parquet, at the cost of one D2H fetch per column now and
    one H2D copy at re-promotion. Fetches ride the transfer engine (d2h
    telemetry); host columns pass through. Every payload OWNS its
    memory (`_owned_host`)."""
    fetched = _fetch_columns(batch)
    out: Dict[str, DeviceColumn] = {}
    for name, col in batch.columns.items():
        if col.is_host:
            out[name] = col
            continue
        data, validity = fetched[name]
        hashes = col.dict_hashes
        if hashes is not None:
            hashes = (_to_numpy(hashes[0]).astype(np.uint32),
                      _to_numpy(hashes[1]).astype(np.uint32))
        out[name] = DeviceColumn(
            data=_owned_host(data), dtype=col.dtype,
            validity=(_owned_host(validity) if validity is not None
                      else None),
            dictionary=col.dictionary, dict_hashes=hashes)
    return ColumnBatch(batch.schema, out)


def host_batch_to_device(batch: ColumnBatch, device: torch.device,
                         transfer_tag: Optional[str] = None
                         ) -> ColumnBatch:
    """Host ColumnBatch -> a batch on `device` through the pipelined
    transfer engine — also the segment cache's RE-PROMOTION of a demoted
    entry: H2D paid, parquet decode skipped. `transfer_tag` rides the
    same lane accounting as fills (`tag="fill"` lands in
    `transfer.fill.*`). Device columns pass through."""
    from hyperspace_tpu_torch.io import transfer

    def job(col: DeviceColumn):
        def run() -> dict:
            produced = {"data": np.asarray(col.data)}
            if col.validity is not None:
                produced["validity"] = np.asarray(col.validity)
            if col.dict_hashes is not None:
                produced["hash_hi"] = transfer.HostCast(
                    np.asarray(col.dict_hashes[0]), np.int64)
                produced["hash_lo"] = transfer.HostCast(
                    np.asarray(col.dict_hashes[1]), np.int64)
            return produced
        return run

    fields = [f for f in batch.schema.fields
              if batch.columns[f.name].is_host]
    placed = transfer.get_engine().put_group(
        [job(batch.columns[f.name]) for f in fields], device=device,
        tag=transfer_tag)
    out = dict(batch.columns)
    for f, entry in zip(fields, placed):
        out[f.name] = _placed_column(f, entry,
                                     batch.columns[f.name].dictionary)
    return ColumnBatch(batch.schema, {f.name: out[f.name]
                                      for f in batch.schema.fields})


def _merged_dictionary(dictionaries, device: Optional[torch.device]):
    """Merge sorted dictionaries and build remap tables + value hashes.
    Returns (merged, [remap array per input], (hi, lo)) in the residence
    `device` names (None = host)."""
    merged = np.unique(np.concatenate(list(dictionaries)))
    remaps = [np.searchsorted(merged, d).astype(np.int32)
              for d in dictionaries]
    if device is not None:
        remaps = [_to_device(r, device) for r in remaps]
    return merged, remaps, _split_hashes(_string_hash64(merged), device)


def concat_batches(batches: List[ColumnBatch]) -> ColumnBatch:
    """Concatenate batches row-wise. String columns are re-unified through
    a merged sorted dictionary so codes stay order-preserving and
    comparable. All-host inputs concatenate on the host lane; any device
    input promotes the result to that device (the host inputs take one
    H2D copy per column)."""
    if not batches:
        raise HyperspaceException("Cannot concat zero batches.")
    if len(batches) == 1:
        return batches[0]
    device = next((b.device for b in batches if not b.is_host), None)
    if device is not None:
        batches = [host_batch_to_device(b, device) if b.is_host else b
                   for b in batches]

    def cat(arrays):
        return (np.concatenate(arrays) if device is None
                else torch.cat(arrays))

    def ones(n):
        return (np.ones(n, dtype=bool) if device is None
                else torch.ones(n, dtype=torch.bool, device=device))

    schema = batches[0].schema
    out: Dict[str, DeviceColumn] = {}
    for f in schema.fields:
        cols = [b.columns[f.name] for b in batches]
        validity = None
        if any(c.validity is not None for c in cols):
            validity = cat([c.validity if c.validity is not None
                            else ones(len(c)) for c in cols])
        if f.dtype == "string":
            merged, remaps, hashes = _merged_dictionary(
                [c.dictionary for c in cols], device)
            codes = [remap[c.data] if device is None
                     else remap[c.data.to(torch.int64)]
                     for remap, c in zip(remaps, cols)]
            out[f.name] = DeviceColumn(cat(codes), "string", validity,
                                       merged, hashes)
        else:
            out[f.name] = DeviceColumn(cat([c.data for c in cols]), f.dtype,
                                       validity)
    return ColumnBatch(schema, out)


def unify_string_columns(a: DeviceColumn, b: DeviceColumn):
    """Re-map two string columns onto one merged sorted dictionary so their
    codes are mutually comparable (used by the join path). Both columns
    are in the same residence: numpy on the host lane, tensors on one
    device."""
    device = None if a.is_host else a.data.device
    merged, (remap_a, remap_b), hashes = _merged_dictionary(
        [a.dictionary, b.dictionary], device)

    def remap(col: DeviceColumn, table) -> DeviceColumn:
        codes = (table[col.data] if device is None
                 else table[col.data.to(torch.int64)])
        return DeviceColumn(codes, "string", col.validity, merged, hashes)

    return remap(a, remap_a), remap(b, remap_b)


def batch_to_tree(batch: ColumnBatch):
    """ColumnBatch -> (dict of per-column arrays, host aux).

    The tree holds per-column {"data", "validity", "hash_hi", "hash_lo"}
    (absent entries omitted); aux carries the host-side dictionaries
    needed to rebuild the batch."""
    tree = {}
    aux = {}
    for f in batch.schema.fields:
        col = batch.columns[f.name]
        entry = {"data": col.data}
        if col.validity is not None:
            entry["validity"] = col.validity
        if col.is_string:
            entry["hash_hi"], entry["hash_lo"] = col.dict_hashes
        tree[f.name] = entry
        aux[f.name] = col.dictionary
    return tree, aux


def tree_to_batch(tree, schema: Schema, aux) -> ColumnBatch:
    columns = {}
    for f in schema.fields:
        entry = tree[f.name]
        dict_hashes = None
        if "hash_hi" in entry:
            dict_hashes = (entry["hash_hi"], entry["hash_lo"])
        columns[f.name] = DeviceColumn(
            data=entry["data"], dtype=f.dtype,
            validity=entry.get("validity"),
            dictionary=aux.get(f.name),
            dict_hashes=dict_hashes)
    return ColumnBatch(schema, columns)
