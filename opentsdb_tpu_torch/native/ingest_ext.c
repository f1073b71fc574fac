/* CPython extension for the batch-ingest hot loops of the PyTorch port.
 *
 * A copy of the JAX package's native/ingest_ext.c (the same seven
 * functions, the same semantics), built by
 * opentsdb_tpu_torch/utils/nativeext.py at first use. Only the module's
 * name differs: tsd_ingest_ext_torch, so that the port's copy and the
 * JAX package's tsd_ingest_ext can load into one process.
 *
 * Measured motivation (the JAX package's 10M-point sustained-ingest
 * attribution, one CPU core): after the WAL record and encode buffers
 * were vectorized, the remaining cost of at-scale ingest was
 * interpreter-level per-cell work -- building one bytes key + one
 * {(family, qual): value} dict per row-hour for the memtable (~3 s /
 * 1.75M cells) and slicing the per-row qualifier/value bytes out of the
 * encode buffers (~1.9 s). Both are pure allocation loops with no Python
 * semantics, so they belong in C; the Python paths in storage/kv.py,
 * storage/sstable.py and core/codec_np.py remain the reference
 * implementations the tests hold these against.
 *
 * Reference parity note: the reference's ingest hot path is Java
 * (src/core/TSDB.java:240-352 + IncomingDataPoints); this plays the
 * same role here -- the card does query compute, C does the row
 * bookkeeping.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

/* slice_keys(blob: bytes, key_len: int) -> list[bytes]
 * The i-th element is blob[i*key_len:(i+1)*key_len]. */
static PyObject *
slice_keys(PyObject *self, PyObject *args)
{
    Py_buffer blob;
    Py_ssize_t klen;
    if (!PyArg_ParseTuple(args, "y*n", &blob, &klen))
        return NULL;
    if (klen <= 0 || blob.len % klen != 0) {
        PyBuffer_Release(&blob);
        PyErr_SetString(PyExc_ValueError,
                        "blob length not a multiple of key_len");
        return NULL;
    }
    Py_ssize_t n = blob.len / klen;
    PyObject *out = PyList_New(n);
    if (!out) {
        PyBuffer_Release(&blob);
        return NULL;
    }
    const char *p = (const char *)blob.buf;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *k = PyBytes_FromStringAndSize(p + i * klen, klen);
        if (!k) {
            Py_DECREF(out);
            PyBuffer_Release(&blob);
            return NULL;
        }
        PyList_SET_ITEM(out, i, k);   /* steals ref */
    }
    PyBuffer_Release(&blob);
    return out;
}

/* rows_update_new(rows: dict, keys: list[bytes], family: bytes,
 *                 quals: list[bytes], vals: list[bytes]) -> None
 * For each i: rows[keys[i]] = {(family, quals[i]): vals[i]}.
 * Caller guarantees keys are NOT already present (the no-duplicate
 * fast path) - existing rows would be OVERWRITTEN, which is why the
 * Python caller checks `rows.keys() & keys` first. */
static PyObject *
rows_update_new(PyObject *self, PyObject *args)
{
    PyObject *rows, *keys, *family, *quals, *vals;
    if (!PyArg_ParseTuple(args, "O!O!SO!O!", &PyDict_Type, &rows,
                          &PyList_Type, &keys, &family,
                          &PyList_Type, &quals, &PyList_Type, &vals))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(keys);
    if (PyList_GET_SIZE(quals) != n || PyList_GET_SIZE(vals) != n) {
        PyErr_SetString(PyExc_ValueError, "length mismatch");
        return NULL;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *ck = PyTuple_Pack(2, family, PyList_GET_ITEM(quals, i));
        if (!ck)
            return NULL;
        PyObject *row = PyDict_New();
        if (!row) {
            Py_DECREF(ck);
            return NULL;
        }
        if (PyDict_SetItem(row, ck, PyList_GET_ITEM(vals, i)) < 0 ||
            PyDict_SetItem(rows, PyList_GET_ITEM(keys, i), row) < 0) {
            Py_DECREF(ck);
            Py_DECREF(row);
            return NULL;
        }
        Py_DECREF(ck);
        Py_DECREF(row);
    }
    Py_RETURN_NONE;
}

/* slice_varlen(blob: bytes, lens_be_u32: bytes) -> list[bytes]
 * Split `blob` into len(lens)/4 consecutive slices whose byte lengths
 * are given by the big-endian uint32 array `lens_be_u32` (the wire/
 * footer layout both WAL batch records and sstable v2 footers use).
 * Bulk loaders (WAL replay, sstable index open) call this instead of
 * a per-item Python slice loop. */
static PyObject *
slice_varlen(PyObject *self, PyObject *args)
{
    Py_buffer blob, lens;
    if (!PyArg_ParseTuple(args, "y*y*", &blob, &lens))
        return NULL;
    PyObject *out = NULL;
    if (lens.len % 4 != 0) {
        PyErr_SetString(PyExc_ValueError, "lens not a u32 array");
        goto done;
    }
    Py_ssize_t n = lens.len / 4;
    const unsigned char *lp = (const unsigned char *)lens.buf;
    const char *bp = (const char *)blob.buf;
    Py_ssize_t off = 0;
    out = PyList_New(n);
    if (!out)
        goto done;
    for (Py_ssize_t i = 0; i < n; i++) {
        uint32_t ln = ((uint32_t)lp[4 * i] << 24)
            | ((uint32_t)lp[4 * i + 1] << 16)
            | ((uint32_t)lp[4 * i + 2] << 8) | lp[4 * i + 3];
        if (off + (Py_ssize_t)ln > blob.len) {
            Py_CLEAR(out);
            PyErr_SetString(PyExc_ValueError, "lens overrun blob");
            goto done;
        }
        PyObject *b = PyBytes_FromStringAndSize(bp + off, ln);
        if (!b) {
            Py_CLEAR(out);
            goto done;
        }
        PyList_SET_ITEM(out, i, b);
        off += ln;
    }
done:
    PyBuffer_Release(&blob);
    PyBuffer_Release(&lens);
    return out;
}

/* upsert_cells(rows: dict, keys: list[bytes], family: bytes,
 *              quals: list[bytes], vals: list[bytes], pending: set)
 *     -> existed: list[bool]
 * Full put_many semantics for the PURE-MEMTABLE store (no lower
 * tiers, so no tombstones and existence == presence in rows): for
 * each i, set {(family, quals[i]): vals[i]} into rows[keys[i]],
 * creating the row when absent. existed[i] is True when the row held
 * cells before cell i landed (pre-existing row OR an earlier cell of
 * this batch - matching KVStore.put_many's contract). A created
 * row's key goes into `pending` (the _Table sorted-key index)
 * IMMEDIATELY after the insert, so an allocation failure mid-batch
 * can never leave a row in `rows` that scans will not see; a set-add
 * failure rolls the row insert back before raising for the same
 * reason. The caller must have ruled out a mid-batch throttle trip. */
static PyObject *
upsert_cells(PyObject *self, PyObject *args)
{
    PyObject *rows, *keys, *family, *quals, *vals, *pending;
    if (!PyArg_ParseTuple(args, "O!O!SO!O!O!", &PyDict_Type, &rows,
                          &PyList_Type, &keys, &family,
                          &PyList_Type, &quals, &PyList_Type, &vals,
                          &PySet_Type, &pending))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(keys);
    if (PyList_GET_SIZE(quals) != n || PyList_GET_SIZE(vals) != n) {
        PyErr_SetString(PyExc_ValueError, "length mismatch");
        return NULL;
    }
    PyObject *existed = PyList_New(n);
    if (!existed)
        return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *key = PyList_GET_ITEM(keys, i);
        PyObject *row = PyDict_GetItemWithError(rows, key); /* borrowed */
        if (!row && PyErr_Occurred())
            goto fail;
        int was_new = (row == NULL);
        if (was_new) {
            row = PyDict_New();
            if (!row)
                goto fail;
            if (PyDict_SetItem(rows, key, row) < 0) {
                Py_DECREF(row);
                goto fail;
            }
            Py_DECREF(row);   /* rows holds the ref; row stays valid */
            if (PySet_Add(pending, key) < 0) {
                PyDict_DelItem(rows, key);
                goto fail;
            }
        }
        PyObject *ck = PyTuple_Pack(2, family, PyList_GET_ITEM(quals, i));
        if (!ck)
            goto fail;
        if (PyDict_SetItem(row, ck, PyList_GET_ITEM(vals, i)) < 0) {
            Py_DECREF(ck);
            goto fail;
        }
        Py_DECREF(ck);
        PyObject *flag = was_new ? Py_False : Py_True;
        Py_INCREF(flag);
        PyList_SET_ITEM(existed, i, flag);
    }
    return existed;
fail:
    Py_XDECREF(existed);
    return NULL;
}

/* slice_cells(quals: bytes, vbytes: bytes,
 *             row_starts: buffer[int64], row_ends: buffer[int64],
 *             val_starts: buffer[int64], val_ends: buffer[int64])
 *     -> (list[bytes], list[bytes])
 * Per row i: qual = quals[2*rs[i]:2*re[i]],
 *            val  = vbytes[vs[i]:ve[i]] (+ b"\x00" when re-rs > 1). */
static PyObject *
slice_cells(PyObject *self, PyObject *args)
{
    Py_buffer qb, vb, rs, re, vs, ve;
    if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*", &qb, &vb, &rs, &re,
                          &vs, &ve))
        return NULL;
    PyObject *out_q = NULL, *out_v = NULL, *ret = NULL;
    Py_ssize_t n = rs.len / (Py_ssize_t)sizeof(int64_t);
    if (re.len != rs.len || vs.len != rs.len || ve.len != rs.len) {
        PyErr_SetString(PyExc_ValueError, "bounds length mismatch");
        goto done;
    }
    const int64_t *prs = (const int64_t *)rs.buf;
    const int64_t *pre = (const int64_t *)re.buf;
    const int64_t *pvs = (const int64_t *)vs.buf;
    const int64_t *pve = (const int64_t *)ve.buf;
    const char *q = (const char *)qb.buf;
    const char *v = (const char *)vb.buf;
    out_q = PyList_New(n);
    out_v = PyList_New(n);
    if (!out_q || !out_v)
        goto done;
    for (Py_ssize_t i = 0; i < n; i++) {
        int64_t a = prs[i], b = pre[i], va = pvs[i], ve_ = pve[i];
        if (a < 0 || b < a || 2 * b > qb.len || va < 0 || ve_ < va ||
            ve_ > vb.len) {
            PyErr_SetString(PyExc_ValueError, "bounds out of range");
            goto done;
        }
        PyObject *qs = PyBytes_FromStringAndSize(q + 2 * a,
                                                 2 * (b - a));
        if (!qs)
            goto done;
        PyList_SET_ITEM(out_q, i, qs);
        int multi = (b - a) > 1;
        PyObject *vo = PyBytes_FromStringAndSize(NULL,
                                                 (ve_ - va) + multi);
        if (!vo)
            goto done;
        char *dst = PyBytes_AS_STRING(vo);
        memcpy(dst, v + va, (size_t)(ve_ - va));
        if (multi)
            dst[ve_ - va] = '\0';
        PyList_SET_ITEM(out_v, i, vo);
    }
    ret = PyTuple_Pack(2, out_q, out_v);
done:
    Py_XDECREF(out_q);
    Py_XDECREF(out_v);
    PyBuffer_Release(&qb);
    PyBuffer_Release(&vb);
    PyBuffer_Release(&rs);
    PyBuffer_Release(&re);
    PyBuffer_Release(&vs);
    PyBuffer_Release(&ve);
    return ret;
}

/* frame_rows_dict(table: bytes, keys: list[bytes], rows: dict, base)
 *     -> (records, offsets_be_u64, key_lens_be_u32)
 * Like frame_rows, but reads each row's cells straight out of the
 * memtable dict (key -> {(fam, qual): value}) — no per-row Python
 * materialization pass. Caller guarantees keys are sorted, present,
 * and rows hold no None (tombstone) values; multi-cell rows' cells
 * are sorted here (by (fam, qual), matching the Python spill). */
static PyObject *
frame_rows_dict(PyObject *self, PyObject *args)
{
    PyObject *tb, *keys, *rows;
    unsigned long long base;
    if (!PyArg_ParseTuple(args, "SO!O!K", &tb, &PyList_Type, &keys,
                          &PyDict_Type, &rows, &base))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(keys);
    Py_ssize_t tlen = PyBytes_GET_SIZE(tb);
    /* pass 1: size + validation */
    size_t total = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *key = PyList_GET_ITEM(keys, i);
        PyObject *row = PyDict_GetItemWithError(rows, key);
        if (!row) {
            if (!PyErr_Occurred())
                PyErr_SetString(PyExc_KeyError, "key not in rows");
            return NULL;
        }
        if (!PyBytes_Check(key) || !PyDict_Check(row)) {
            PyErr_SetString(PyExc_TypeError, "bad key/row types");
            return NULL;
        }
        total += 2 + (size_t)tlen + 2 + (size_t)PyBytes_GET_SIZE(key) + 4;
        PyObject *ck, *cv;
        Py_ssize_t pos = 0;
        while (PyDict_Next(row, &pos, &ck, &cv)) {
            if (!PyTuple_Check(ck) || PyTuple_GET_SIZE(ck) != 2 ||
                !PyBytes_Check(PyTuple_GET_ITEM(ck, 0)) ||
                !PyBytes_Check(PyTuple_GET_ITEM(ck, 1)) ||
                !PyBytes_Check(cv)) {
                PyErr_SetString(PyExc_TypeError,
                                "row cells must be {(bytes, bytes): "
                                "bytes} with no tombstones");
                return NULL;
            }
            total += 2 + (size_t)PyBytes_GET_SIZE(PyTuple_GET_ITEM(ck, 0))
                + 2 + (size_t)PyBytes_GET_SIZE(PyTuple_GET_ITEM(ck, 1))
                + 4 + (size_t)PyBytes_GET_SIZE(cv);
        }
    }
    PyObject *records = PyBytes_FromStringAndSize(NULL,
                                                  (Py_ssize_t)total);
    PyObject *offs = PyBytes_FromStringAndSize(NULL, 8 * n);
    PyObject *klens = PyBytes_FromStringAndSize(NULL, 4 * n);
    PyObject *scratch = NULL;
    if (!records || !offs || !klens)
        goto fail;
    unsigned char *p = (unsigned char *)PyBytes_AS_STRING(records);
    unsigned char *po = (unsigned char *)PyBytes_AS_STRING(offs);
    unsigned char *pk = (unsigned char *)PyBytes_AS_STRING(klens);
    const char *tp = PyBytes_AS_STRING(tb);
    size_t off = 0;

#define W16(x) do { *p++ = (unsigned char)((x) >> 8); \
                    *p++ = (unsigned char)(x); } while (0)
#define W32(x) do { *p++ = (unsigned char)((x) >> 24); \
                    *p++ = (unsigned char)((x) >> 16); \
                    *p++ = (unsigned char)((x) >> 8); \
                    *p++ = (unsigned char)(x); } while (0)

    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *key = PyList_GET_ITEM(keys, i);
        PyObject *row = PyDict_GetItem(rows, key);  /* borrowed */
        unsigned long long abs_off = base + off;
        for (int b = 7; b >= 0; b--)
            *po++ = (unsigned char)(abs_off >> (8 * b));
        Py_ssize_t klen = PyBytes_GET_SIZE(key);
        *pk++ = (unsigned char)((unsigned)klen >> 24);
        *pk++ = (unsigned char)((unsigned)klen >> 16);
        *pk++ = (unsigned char)((unsigned)klen >> 8);
        *pk++ = (unsigned char)klen;
        unsigned char *rec0 = p;
        W16(tlen);
        memcpy(p, tp, (size_t)tlen);
        p += tlen;
        W16(klen);
        memcpy(p, PyBytes_AS_STRING(key), (size_t)klen);
        p += klen;
        Py_ssize_t nc = PyDict_GET_SIZE(row);
        W32(nc);
        PyObject *ck, *cv;
        Py_ssize_t pos = 0;
        if (nc == 1) {
            PyDict_Next(row, &pos, &ck, &cv);
        } else {
            /* multi-cell: sort cell keys (rare) */
            scratch = PySequence_List(row);   /* list of (fam, qual) */
            if (!scratch || PyList_Sort(scratch) < 0)
                goto fail;
        }
        for (Py_ssize_t j = 0; j < nc; j++) {
            if (nc != 1) {
                ck = PyList_GET_ITEM(scratch, j);
                cv = PyDict_GetItem(row, ck);
                if (!cv)
                    goto fail;
            }
            PyObject *f = PyTuple_GET_ITEM(ck, 0);
            PyObject *q = PyTuple_GET_ITEM(ck, 1);
            W16(PyBytes_GET_SIZE(f));
            memcpy(p, PyBytes_AS_STRING(f),
                   (size_t)PyBytes_GET_SIZE(f));
            p += PyBytes_GET_SIZE(f);
            W16(PyBytes_GET_SIZE(q));
            memcpy(p, PyBytes_AS_STRING(q),
                   (size_t)PyBytes_GET_SIZE(q));
            p += PyBytes_GET_SIZE(q);
            W32(PyBytes_GET_SIZE(cv));
            memcpy(p, PyBytes_AS_STRING(cv),
                   (size_t)PyBytes_GET_SIZE(cv));
            p += PyBytes_GET_SIZE(cv);
        }
        Py_CLEAR(scratch);
        off += (size_t)(p - rec0);
    }
#undef W16
#undef W32
    {
        PyObject *ret = PyTuple_Pack(3, records, offs, klens);
        Py_DECREF(records);
        Py_DECREF(offs);
        Py_DECREF(klens);
        return ret;
    }
fail:
    Py_XDECREF(scratch);
    Py_XDECREF(records);
    Py_XDECREF(offs);
    Py_XDECREF(klens);
    return NULL;
}

/* frame_rows(table: bytes, keys: list[bytes],
 *            cells: list[list[(fam, qual, value)]], base: int)
 *     -> (records: bytes, offsets_be_u64: bytes, key_lens_be_u32: bytes)
 * Frame one table's rows in the sstable record layout
 * ([u16 tlen][table][u16 klen][key][u32 ncells]([u16 flen][fam][u16
 * qlen][q][u32 vlen][v])*), plus the v2 footer arrays (absolute record
 * offsets starting at `base`, big-endian). One C pass replaces the
 * ~5 us/row Python framing loop that dominated checkpoint spills. */
static PyObject *
frame_rows(PyObject *self, PyObject *args)
{
    PyObject *tb, *keys, *cells;
    unsigned long long base;
    if (!PyArg_ParseTuple(args, "SO!O!K", &tb, &PyList_Type, &keys,
                          &PyList_Type, &cells, &base))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(keys);
    Py_ssize_t tlen = PyBytes_GET_SIZE(tb);
    if (PyList_GET_SIZE(cells) != n) {
        PyErr_SetString(PyExc_ValueError, "keys/cells length mismatch");
        return NULL;
    }
    /* pass 1: validate + total size */
    size_t total = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *key = PyList_GET_ITEM(keys, i);
        PyObject *row = PyList_GET_ITEM(cells, i);
        if (!PyBytes_Check(key) || !PyList_Check(row)) {
            PyErr_SetString(PyExc_TypeError,
                            "keys must be bytes, cells must be lists");
            return NULL;
        }
        total += 2 + (size_t)tlen + 2 + (size_t)PyBytes_GET_SIZE(key) + 4;
        for (Py_ssize_t j = 0; j < PyList_GET_SIZE(row); j++) {
            PyObject *c = PyList_GET_ITEM(row, j);
            if (!PyTuple_Check(c) || PyTuple_GET_SIZE(c) != 3 ||
                !PyBytes_Check(PyTuple_GET_ITEM(c, 0)) ||
                !PyBytes_Check(PyTuple_GET_ITEM(c, 1)) ||
                !PyBytes_Check(PyTuple_GET_ITEM(c, 2))) {
                PyErr_SetString(PyExc_TypeError,
                                "cells must be (bytes, bytes, bytes)");
                return NULL;
            }
            total += 2 + (size_t)PyBytes_GET_SIZE(PyTuple_GET_ITEM(c, 0))
                + 2 + (size_t)PyBytes_GET_SIZE(PyTuple_GET_ITEM(c, 1))
                + 4 + (size_t)PyBytes_GET_SIZE(PyTuple_GET_ITEM(c, 2));
        }
    }
    PyObject *records = PyBytes_FromStringAndSize(NULL,
                                                  (Py_ssize_t)total);
    PyObject *offs = PyBytes_FromStringAndSize(NULL, 8 * n);
    PyObject *klens = PyBytes_FromStringAndSize(NULL, 4 * n);
    if (!records || !offs || !klens) {
        Py_XDECREF(records);
        Py_XDECREF(offs);
        Py_XDECREF(klens);
        return NULL;
    }
    unsigned char *p = (unsigned char *)PyBytes_AS_STRING(records);
    unsigned char *po = (unsigned char *)PyBytes_AS_STRING(offs);
    unsigned char *pk = (unsigned char *)PyBytes_AS_STRING(klens);
    const char *tp = PyBytes_AS_STRING(tb);
    size_t off = 0;

#define W16(x) do { *p++ = (unsigned char)((x) >> 8); \
                    *p++ = (unsigned char)(x); } while (0)
#define W32(x) do { *p++ = (unsigned char)((x) >> 24); \
                    *p++ = (unsigned char)((x) >> 16); \
                    *p++ = (unsigned char)((x) >> 8); \
                    *p++ = (unsigned char)(x); } while (0)

    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *key = PyList_GET_ITEM(keys, i);
        PyObject *row = PyList_GET_ITEM(cells, i);
        unsigned long long abs_off = base + off;
        for (int b = 7; b >= 0; b--)
            *po++ = (unsigned char)(abs_off >> (8 * b));
        Py_ssize_t klen = PyBytes_GET_SIZE(key);
        *pk++ = (unsigned char)((unsigned)klen >> 24);
        *pk++ = (unsigned char)((unsigned)klen >> 16);
        *pk++ = (unsigned char)((unsigned)klen >> 8);
        *pk++ = (unsigned char)klen;
        unsigned char *rec0 = p;
        W16(tlen);
        memcpy(p, tp, (size_t)tlen);
        p += tlen;
        W16(klen);
        memcpy(p, PyBytes_AS_STRING(key), (size_t)klen);
        p += klen;
        Py_ssize_t nc = PyList_GET_SIZE(row);
        W32(nc);
        for (Py_ssize_t j = 0; j < nc; j++) {
            PyObject *c = PyList_GET_ITEM(row, j);
            PyObject *f = PyTuple_GET_ITEM(c, 0);
            PyObject *q = PyTuple_GET_ITEM(c, 1);
            PyObject *v = PyTuple_GET_ITEM(c, 2);
            W16(PyBytes_GET_SIZE(f));
            memcpy(p, PyBytes_AS_STRING(f),
                   (size_t)PyBytes_GET_SIZE(f));
            p += PyBytes_GET_SIZE(f);
            W16(PyBytes_GET_SIZE(q));
            memcpy(p, PyBytes_AS_STRING(q),
                   (size_t)PyBytes_GET_SIZE(q));
            p += PyBytes_GET_SIZE(q);
            W32(PyBytes_GET_SIZE(v));
            memcpy(p, PyBytes_AS_STRING(v),
                   (size_t)PyBytes_GET_SIZE(v));
            p += PyBytes_GET_SIZE(v);
        }
        off += (size_t)(p - rec0);
    }
#undef W16
#undef W32
    PyObject *ret = PyTuple_Pack(3, records, offs, klens);
    Py_DECREF(records);
    Py_DECREF(offs);
    Py_DECREF(klens);
    return ret;
}

static PyMethodDef Methods[] = {
    {"slice_keys", slice_keys, METH_VARARGS,
     "Slice a contiguous key blob into a list of fixed-width keys."},
    {"rows_update_new", rows_update_new, METH_VARARGS,
     "Bulk-insert single-cell rows into a memtable dict."},
    {"upsert_cells", upsert_cells, METH_VARARGS,
     "Full batch upsert with existed flags (pure-memtable store)."},
    {"slice_varlen", slice_varlen, METH_VARARGS,
     "Split a blob into slices sized by a big-endian u32 length array."},
    {"frame_rows", frame_rows, METH_VARARGS,
     "Frame one table's rows as sstable records + v2 footer arrays."},
    {"frame_rows_dict", frame_rows_dict, METH_VARARGS,
     "frame_rows reading cells straight from the memtable dict."},
    {"slice_cells", slice_cells, METH_VARARGS,
     "Slice per-row qualifier/value bytes out of encode buffers."},
    {NULL, NULL, 0, NULL}
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "tsd_ingest_ext_torch",
    "C hot loops for batch ingest (see file docstring).", -1, Methods
};

PyMODINIT_FUNC
PyInit_tsd_ingest_ext_torch(void)
{
    return PyModule_Create(&module);
}
