/* numpy allocation handler: MAP_SHARED-backed large buffers.
 *
 * On this kernel (virtualized snapshot/fork environment) write-faulting
 * MAP_PRIVATE anonymous memory runs ~20-40 MB/s while MAP_SHARED
 * anonymous memory faults at >1 GB/s (measured 70x).  glibc malloc backs
 * every large allocation with MAP_PRIVATE mmap and returns it to the OS
 * on free, so each big numpy temporary pays the pathological fault path
 * again.  This handler routes numpy allocations >= 2 MB to
 * MAP_SHARED|MAP_ANONYMOUS mmap chunks and keeps a small free-list of
 * returned chunks so steady-state reuse does not fault at all.
 *
 * Each allocation carries a 64-byte header (magic, origin, usable size)
 * so free/realloc can dispatch without knowing the origin a priori.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_TARGET_VERSION NPY_1_22_API_VERSION
#define NPY_NO_DEPRECATED_API NPY_1_22_API_VERSION
#include <numpy/arrayobject.h>

#include <pthread.h>
#include <string.h>
#include <sys/mman.h>

#define HDR 64
#define MAGIC_MALLOC 0x68544d414c4c4f43ULL
#define MAGIC_MMAP 0x68544d4d41505047ULL
#define MMAP_THRESHOLD (2u << 20)
#define CACHE_SLOTS 16
/* keep at most ~6 GB parked in the free-list */
#define CACHE_MAX_BYTES (6ULL << 30)

typedef struct {
    uint64_t magic;
    size_t size; /* usable bytes (excluding header) */
} hdr_t;

typedef struct {
    void *base;  /* mmap base (header start) */
    size_t size; /* usable bytes */
} cache_ent_t;

static cache_ent_t cache[CACHE_SLOTS];
static size_t cache_bytes = 0;
static pthread_mutex_t cache_mu = PTHREAD_MUTEX_INITIALIZER;

static void *mmap_chunk(size_t usable) {
    /* round the whole chunk to 2 MB so cache reuse buckets cleanly */
    size_t total = (usable + HDR + ((2u << 20) - 1)) & ~(size_t)((2u << 20) - 1);
    size_t best = (size_t)-1;
    int besti = -1;
    pthread_mutex_lock(&cache_mu);
    for (int i = 0; i < CACHE_SLOTS; i++) {
        if (!cache[i].base) continue;
        size_t have = cache[i].size + HDR;
        if (have >= total && have <= total * 2 && have < best) {
            best = have;
            besti = i;
        }
    }
    if (besti >= 0) {
        void *base = cache[besti].base;
        size_t usz = cache[besti].size;
        cache[besti].base = NULL;
        cache_bytes -= usz + HDR;
        pthread_mutex_unlock(&cache_mu);
        hdr_t *h = (hdr_t *)base;
        h->magic = MAGIC_MMAP;
        h->size = usz;
        return (char *)base + HDR;
    }
    pthread_mutex_unlock(&cache_mu);
    void *base = mmap(NULL, total, PROT_READ | PROT_WRITE,
                      MAP_SHARED | MAP_ANONYMOUS, -1, 0);
    if (base == MAP_FAILED) return NULL;
    hdr_t *h = (hdr_t *)base;
    h->magic = MAGIC_MMAP;
    h->size = total - HDR;
    return (char *)base + HDR;
}

static void mmap_release(void *base, size_t usable) {
    pthread_mutex_lock(&cache_mu);
    if (cache_bytes + usable + HDR <= CACHE_MAX_BYTES) {
        for (int i = 0; i < CACHE_SLOTS; i++) {
            if (!cache[i].base) {
                cache[i].base = base;
                cache[i].size = usable;
                cache_bytes += usable + HDR;
                pthread_mutex_unlock(&cache_mu);
                return;
            }
        }
        /* no slot: evict the smallest cached chunk */
        int mi = 0;
        for (int i = 1; i < CACHE_SLOTS; i++)
            if (cache[i].size < cache[mi].size) mi = i;
        if (cache[mi].size < usable) {
            void *evb = cache[mi].base;
            size_t evs = cache[mi].size;
            cache[mi].base = base;
            cache[mi].size = usable;
            cache_bytes += usable - evs;
            pthread_mutex_unlock(&cache_mu);
            munmap(evb, evs + HDR);
            return;
        }
    }
    pthread_mutex_unlock(&cache_mu);
    munmap(base, usable + HDR);
}

static void *h_alloc(size_t size) {
    if (size >= MMAP_THRESHOLD) {
        void *p = mmap_chunk(size);
        if (p) return p;
    }
    char *raw = (char *)malloc(size + HDR);
    if (!raw) return NULL;
    hdr_t *h = (hdr_t *)raw;
    h->magic = MAGIC_MALLOC;
    h->size = size;
    return raw + HDR;
}

static void *arena_malloc(void *ctx, size_t size) {
    (void)ctx;
    return h_alloc(size ? size : 1);
}

static void *arena_calloc(void *ctx, size_t nelem, size_t elsize) {
    (void)ctx;
    size_t size = nelem * elsize;
    if (elsize && size / elsize != nelem) return NULL;
    void *p = h_alloc(size ? size : 1);
    if (p) memset(p, 0, size);
    return p;
}

static void arena_free(void *ctx, void *ptr, size_t size) {
    (void)ctx;
    (void)size;
    if (!ptr) return;
    hdr_t *h = (hdr_t *)((char *)ptr - HDR);
    if (h->magic == MAGIC_MMAP)
        mmap_release((void *)h, h->size);
    else
        free((void *)h);
}

static void *arena_realloc(void *ctx, void *ptr, size_t new_size) {
    (void)ctx;
    if (!ptr) return h_alloc(new_size ? new_size : 1);
    hdr_t *h = (hdr_t *)((char *)ptr - HDR);
    size_t old = h->size;
    if (h->magic == MAGIC_MALLOC && new_size < MMAP_THRESHOLD) {
        char *raw = (char *)realloc((void *)h, new_size + HDR);
        if (!raw) return NULL;
        ((hdr_t *)raw)->size = new_size;
        return raw + HDR;
    }
    if (h->magic == MAGIC_MMAP && new_size <= old)
        return ptr; /* shrink in place */
    void *np = h_alloc(new_size);
    if (!np) return NULL;
    memcpy(np, ptr, old < new_size ? old : new_size);
    arena_free(NULL, ptr, old);
    return np;
}

static PyDataMem_Handler handler = {
    "shared_mmap_arena",
    1,
    {
        NULL,
        arena_malloc,
        arena_calloc,
        arena_realloc,
        arena_free,
    },
};

static PyObject *install(PyObject *self, PyObject *args) {
    (void)self;
    (void)args;
    PyObject *cap = PyCapsule_New(&handler, "mem_handler", NULL);
    if (!cap) return NULL;
    PyObject *old = PyDataMem_SetHandler(cap);
    Py_DECREF(cap);
    if (!old) return NULL;
    Py_DECREF(old);
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"install", install, METH_NOARGS,
     "Route large numpy allocations to MAP_SHARED mmap."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_memarena", NULL, -1, methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__memarena(void) {
    import_array();
    return PyModule_Create(&module);
}
