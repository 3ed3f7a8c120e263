/* Native hot-path helpers for the shared-memory object store.
 *
 * Equivalent of the reference's C++ plasma client copy path
 * (reference: src/ray/object_manager/plasma/client.cc — WriteObject
 * uses multithreaded memcpy for large objects; ray_config_def.h
 * object_store_memcpy_threads).  A single-threaded Python memoryview
 * copy tops out around 4.6 GB/s on this host; splitting the copy
 * across threads reaches ~8 GB/s, and read-touching fresh PTEs in
 * parallel removes most page-fault stalls.
 *
 * Built at first import by ray_tpu/_native/__init__.py:
 *   cc -O3 -shared -fPIC -pthread copyfast.c -o <cache>/copyfast.so
 */

#include <pthread.h>
#include <stddef.h>
#include <string.h>

typedef struct {
    char *dst;
    const char *src;
    size_t n;
} copy_job_t;

static void *copy_run(void *arg) {
    copy_job_t *j = (copy_job_t *)arg;
    memcpy(j->dst, j->src, j->n);
    return 0;
}

/* Copy n bytes using up to nthreads threads (page-aligned chunks).
 * Small copies stay single-threaded: thread spawn costs ~30us. */
void parallel_copy(char *dst, const char *src, size_t n, int nthreads) {
    if (nthreads < 2 || n < (size_t)(1 << 21)) {
        memcpy(dst, src, n);
        return;
    }
    if (nthreads > 64)
        nthreads = 64;
    pthread_t threads[64];
    copy_job_t jobs[64];
    size_t chunk = (n + (size_t)nthreads - 1) / (size_t)nthreads;
    chunk = (chunk + 4095) & ~(size_t)4095;
    int started = 0;
    for (int i = 0; i < nthreads; i++) {
        size_t off = (size_t)i * chunk;
        if (off >= n)
            break;
        size_t len = n - off < chunk ? n - off : chunk;
        jobs[started].dst = dst + off;
        jobs[started].src = src + off;
        jobs[started].n = len;
        if (pthread_create(&threads[started], 0, copy_run,
                           &jobs[started]) != 0) {
            /* thread spawn failed: finish inline */
            memcpy(dst + off, src + off, n - off);
            break;
        }
        started++;
    }
    for (int i = 0; i < started; i++)
        pthread_join(threads[i], 0);
}

typedef struct {
    const volatile char *p;
    size_t n;
} touch_job_t;

static void *touch_run(void *arg) {
    touch_job_t *j = (touch_job_t *)arg;
    volatile char sink = 0;
    for (size_t off = 0; off < j->n; off += 4096)
        sink ^= j->p[off];
    (void)sink;
    return 0;
}

typedef struct {
    volatile char *p;
    size_t n;
} touchw_job_t;

static void *touchw_run(void *arg) {
    touchw_job_t *j = (touchw_job_t *)arg;
    for (size_t off = 0; off < j->n; off += 4096)
        j->p[off] = j->p[off]; /* volatile: not elided; preserves bytes */
    return 0;
}

/* WRITE-fault one byte per page: installs writable PTEs in one pass.
 * A read-touch maps pages read-only and the following store still pays
 * a write-protect upgrade fault per page; callers that are about to
 * overwrite a region they own (plasma put) want this variant. */
void parallel_touch_write(char *p, size_t n, int nthreads) {
    if (nthreads < 2 || n < (size_t)(1 << 22)) {
        touchw_job_t j = {p, n};
        touchw_run(&j);
        return;
    }
    if (nthreads > 64)
        nthreads = 64;
    pthread_t threads[64];
    touchw_job_t jobs[64];
    size_t chunk = (n + (size_t)nthreads - 1) / (size_t)nthreads;
    chunk = (chunk + 4095) & ~(size_t)4095;
    int started = 0;
    for (int i = 0; i < nthreads; i++) {
        size_t off = (size_t)i * chunk;
        if (off >= n)
            break;
        jobs[started].p = p + off;
        jobs[started].n = n - off < chunk ? n - off : chunk;
        if (pthread_create(&threads[started], 0, touchw_run,
                           &jobs[started]) != 0) {
            touchw_job_t j = {p + off, n - off};
            touchw_run(&j);
            break;
        }
        started++;
    }
    for (int i = 0; i < started; i++)
        pthread_join(threads[i], 0);
}

/* Read-fault one byte per page so a following write runs at memcpy
 * speed instead of write-fault speed (PTE setup for already-resident
 * tmpfs pages). */
void parallel_touch(const char *p, size_t n, int nthreads) {
    if (nthreads < 2 || n < (size_t)(1 << 22)) {
        touch_job_t j = {p, n};
        touch_run(&j);
        return;
    }
    if (nthreads > 64)
        nthreads = 64;
    pthread_t threads[64];
    touch_job_t jobs[64];
    size_t chunk = (n + (size_t)nthreads - 1) / (size_t)nthreads;
    chunk = (chunk + 4095) & ~(size_t)4095;
    int started = 0;
    for (int i = 0; i < nthreads; i++) {
        size_t off = (size_t)i * chunk;
        if (off >= n)
            break;
        jobs[started].p = p + off;
        jobs[started].n = n - off < chunk ? n - off : chunk;
        if (pthread_create(&threads[started], 0, touch_run,
                           &jobs[started]) != 0) {
            touch_job_t j = {p + off, n - off};
            touch_run(&j);
            break;
        }
        started++;
    }
    for (int i = 0; i < started; i++)
        pthread_join(threads[i], 0);
}

/* ---------------------------------------------------------------------
 * First-fit free-list allocator with coalescing (the object-store
 * arena allocator; reference: src/ray/object_manager/plasma/malloc.cc
 * is likewise native).  Offsets and sizes are 64-byte aligned, matching
 * the Python FreeListAllocator it replaces.
 */

#include <stdlib.h>

typedef struct {
    size_t off;
    size_t size;
} fl_block_t;

typedef struct {
    size_t capacity;
    size_t allocated;
    fl_block_t *blocks; /* sorted by offset */
    size_t n;
    size_t cap_blocks;
} fl_t;

static size_t fl_align(size_t n) {
    n = n ? n : 1;
    return (n + 63) & ~(size_t)63;
}

void *fl_new(size_t capacity) {
    fl_t *f = (fl_t *)malloc(sizeof(fl_t));
    if (!f)
        return 0;
    f->capacity = capacity;
    f->allocated = 0;
    f->cap_blocks = 16;
    f->blocks = (fl_block_t *)malloc(f->cap_blocks * sizeof(fl_block_t));
    if (!f->blocks) {
        free(f);
        return 0;
    }
    f->blocks[0].off = 0;
    f->blocks[0].size = capacity;
    f->n = 1;
    return f;
}

void fl_destroy(void *h) {
    fl_t *f = (fl_t *)h;
    if (f) {
        free(f->blocks);
        free(f);
    }
}

size_t fl_allocated(void *h) { return ((fl_t *)h)->allocated; }

/* returns the offset, or (size_t)-1 when no block fits */
size_t fl_alloc(void *h, size_t size) {
    fl_t *f = (fl_t *)h;
    size = fl_align(size);
    for (size_t i = 0; i < f->n; i++) {
        if (f->blocks[i].size >= size) {
            size_t off = f->blocks[i].off;
            if (f->blocks[i].size == size) {
                for (size_t j = i + 1; j < f->n; j++)
                    f->blocks[j - 1] = f->blocks[j];
                f->n--;
            } else {
                f->blocks[i].off += size;
                f->blocks[i].size -= size;
            }
            f->allocated += size;
            return off;
        }
    }
    return (size_t)-1;
}

static int fl_grow(fl_t *f) {
    if (f->n < f->cap_blocks)
        return 1;
    size_t ncap = f->cap_blocks * 2;
    fl_block_t *nb =
        (fl_block_t *)realloc(f->blocks, ncap * sizeof(fl_block_t));
    if (!nb)
        return 0;
    f->blocks = nb;
    f->cap_blocks = ncap;
    return 1;
}

/* returns 0 on success, -1 on internal allocation failure (in which
 * case NO state was mutated — the caller may retry the free) */
int fl_free(void *h, size_t offset, size_t size) {
    fl_t *f = (fl_t *)h;
    size = fl_align(size);
    /* reserve block-array capacity BEFORE mutating anything: a failed
     * realloc must not lose the region nor skew `allocated` */
    if (!fl_grow(f))
        return -1;
    f->allocated -= size;
    /* binary search for insertion point (blocks sorted by offset) */
    size_t lo = 0, hi = f->n;
    while (lo < hi) {
        size_t mid = (lo + hi) / 2;
        if (f->blocks[mid].off < offset)
            lo = mid + 1;
        else
            hi = mid;
    }
    /* try to coalesce with the previous / next block without inserting */
    int merged = 0;
    if (lo > 0 &&
        f->blocks[lo - 1].off + f->blocks[lo - 1].size == offset) {
        f->blocks[lo - 1].size += size;
        merged = 1;
        /* may now touch the next block too */
        if (lo < f->n &&
            f->blocks[lo - 1].off + f->blocks[lo - 1].size ==
                f->blocks[lo].off) {
            f->blocks[lo - 1].size += f->blocks[lo].size;
            for (size_t j = lo + 1; j < f->n; j++)
                f->blocks[j - 1] = f->blocks[j];
            f->n--;
        }
    } else if (lo < f->n && offset + size == f->blocks[lo].off) {
        f->blocks[lo].off = offset;
        f->blocks[lo].size += size;
        merged = 1;
    }
    if (!merged) {
        for (size_t j = f->n; j > lo; j--)
            f->blocks[j] = f->blocks[j - 1];
        f->blocks[lo].off = offset;
        f->blocks[lo].size = size;
        f->n++;
    }
    return 0;
}

size_t fl_largest(void *h) {
    fl_t *f = (fl_t *)h;
    size_t best = 0;
    for (size_t i = 0; i < f->n; i++)
        if (f->blocks[i].size > best)
            best = f->blocks[i].size;
    return best;
}
