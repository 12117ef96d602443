/* Native TFRecord record reader (CPython extension) of the PyTorch port.
 *
 * The port's own copy of the JAX package's native reader (the analog of
 * tf.data's C++ TFRecordDataset that the reference's InputReader rides;
 * dataloader.py:404-459): parse the TFRecord framing
 *   [u64 length][u32 masked-crc32c(length)][payload][u32 masked-crc32c(payload)]
 * in C with real CRC32C (Castagnoli) validation; the pure-python reader
 * of data/tfrecord.py skips the CRC checks. Exposes:
 *
 *   read_records(path, verify_crc=True) -> list[bytes]
 *   crc32c(bytes) -> int           (unmasked, for tests)
 *
 * Built on the host by _build.build_tfrecord_native (cc -O3 -fPIC -shared)
 * into _build/; data/tfrecord.py uses it once it is built and falls back
 * to Python otherwise. It runs on the host CPU, never on the card.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

/* ---- CRC32C (Castagnoli, reflected poly 0x82F63B78), table-driven ---- */

static uint32_t crc32c_table[256];
static int table_ready = 0;

static void init_table(void) {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
        crc32c_table[i] = c;
    }
    table_ready = 1;
}

static uint32_t crc32c(const uint8_t *buf, size_t len) {
    if (!table_ready) init_table();
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < len; i++)
        c = crc32c_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

/* TFRecord "masked" crc (tensorflow/core/lib/hash/crc32c.h) */
static uint32_t masked_crc(const uint8_t *buf, size_t len) {
    uint32_t c = crc32c(buf, len);
    return ((c >> 15) | (c << 17)) + 0xa282ead8u;
}

/* ---- read_records(path, verify_crc=True) -> list[bytes] ---- */

static PyObject *read_records(PyObject *self, PyObject *args, PyObject *kw) {
    const char *path;
    int verify = 1;
    static char *kwlist[] = {"path", "verify_crc", NULL};
    if (!PyArg_ParseTupleAndKeywords(args, kw, "s|p", kwlist, &path,
                                     &verify))
        return NULL;

    FILE *f = fopen(path, "rb");
    if (!f) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return NULL;
    }
    PyObject *out = PyList_New(0);
    if (!out) { fclose(f); return NULL; }

    uint8_t header[12];
    uint8_t footer[4];
    uint8_t *buf = NULL;
    size_t cap = 0;

    for (;;) {
        size_t got = fread(header, 1, 12, f);
        if (got == 0) break;                    /* clean EOF */
        if (got < 12) goto truncated;
        uint64_t length;
        uint32_t len_crc;
        memcpy(&length, header, 8);             /* little-endian hosts */
        memcpy(&len_crc, header + 8, 4);
        if (verify && masked_crc(header, 8) != len_crc) {
            PyErr_Format(PyExc_ValueError,
                         "tfrecord length-CRC mismatch in %s", path);
            goto fail;
        }
        if (length > (uint64_t)1 << 34) {       /* 16 GB sanity cap */
            PyErr_Format(PyExc_ValueError,
                         "unreasonable record length %llu in %s",
                         (unsigned long long)length, path);
            goto fail;
        }
        if (length > cap) {
            cap = length < 1 << 16 ? 1 << 16 : length;
            uint8_t *nb = realloc(buf, cap);
            if (!nb) { PyErr_NoMemory(); goto fail; }
            buf = nb;
        }
        if (fread(buf, 1, length, f) < length) goto truncated;
        if (fread(footer, 1, 4, f) < 4) goto truncated;
        if (verify) {
            uint32_t data_crc;
            memcpy(&data_crc, footer, 4);
            if (masked_crc(buf, length) != data_crc) {
                PyErr_Format(PyExc_ValueError,
                             "tfrecord payload-CRC mismatch in %s", path);
                goto fail;
            }
        }
        PyObject *b = PyBytes_FromStringAndSize((const char *)buf,
                                                (Py_ssize_t)length);
        if (!b || PyList_Append(out, b) < 0) { Py_XDECREF(b); goto fail; }
        Py_DECREF(b);
    }
    free(buf);
    fclose(f);
    return out;

truncated:
    PyErr_Format(PyExc_ValueError, "truncated tfrecord file %s", path);
fail:
    free(buf);
    fclose(f);
    Py_DECREF(out);
    return NULL;
}

static PyObject *py_crc32c(PyObject *self, PyObject *arg) {
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
    uint32_t c = crc32c((const uint8_t *)view.buf, (size_t)view.len);
    PyBuffer_Release(&view);
    return PyLong_FromUnsignedLong(c);
}

static PyMethodDef methods[] = {
    {"read_records", (PyCFunction)read_records,
     METH_VARARGS | METH_KEYWORDS,
     "read_records(path, verify_crc=True) -> list[bytes]"},
    {"crc32c", py_crc32c, METH_O, "crc32c(data) -> int"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_tfrecord_native",
    "native TFRecord framing reader with CRC32C validation", -1, methods,
};

PyMODINIT_FUNC PyInit__tfrecord_native(void) {
    init_table();
    return PyModule_Create(&module);
}
