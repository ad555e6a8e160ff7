/* The series sampler's batch gather, on the host.
 *
 *   out[b, t, c, :, :] = series[samples[b] + offsets[t], chans[c], :, :]
 *
 * Port of the JAX package's native/batch_assembler.c with a plain C
 * interface (pointers and sizes, no Python or numpy headers), loaded with
 * ctypes by dlwp_torch/data/native.py. Each (b, t, c) is one row memcpy
 * of H*W floats; the batch is split over a small pthread pool. The
 * caller checks shapes, dtypes, contiguity and index ranges; the ranges
 * are checked again here, so a bad index returns an error and never
 * reads outside the series.
 *
 * Bound: a copy, so memory traffic: every output byte is read once from
 * the series and written once, where numpy's fancy index, channel index,
 * stack and astype copy the batch about four times.
 *
 * Build: cc -O3 -fPIC -shared -pthread (dlwp_torch/kernels/_build.py).
 */

#include <pthread.h>
#include <stdint.h>
#include <string.h>

#define DLWP_MAX_THREADS 16

typedef struct {
    const float *series;     /* (N, V, H*W) contiguous */
    float *out;              /* (B, T, C, H*W) contiguous */
    const int64_t *samples;  /* (B,) */
    const int64_t *offsets;  /* (T,) */
    const int64_t *chans;    /* (C,) */
    int64_t T, C, V, HW;
    int64_t start_b, end_b;  /* this worker's batch slice */
} job_t;

static void *worker(void *arg)
{
    const job_t *j = (const job_t *)arg;
    const size_t row = (size_t)j->HW * sizeof(float);
    for (int64_t b = j->start_b; b < j->end_b; b++) {
        for (int64_t t = 0; t < j->T; t++) {
            const int64_t n = j->samples[b] + j->offsets[t];
            const float *src = j->series + n * j->V * j->HW;
            float *dst = j->out + (b * j->T + t) * j->C * j->HW;
            for (int64_t c = 0; c < j->C; c++)
                memcpy(dst + c * j->HW, src + j->chans[c] * j->HW, row);
        }
    }
    return NULL;
}

/* Returns 0, or 1 for a sample index out of [0, N), 2 for a channel index
 * out of [0, V), 3 when a thread could not be started. */
int dlwp_assemble(const float *series, int64_t N, int64_t V, int64_t HW,
                  const int64_t *samples, int64_t B,
                  const int64_t *offsets, int64_t T,
                  const int64_t *chans, int64_t C,
                  float *out, int n_threads)
{
    for (int64_t b = 0; b < B; b++)
        for (int64_t t = 0; t < T; t++) {
            const int64_t n = samples[b] + offsets[t];
            if (n < 0 || n >= N)
                return 1;
        }
    for (int64_t c = 0; c < C; c++)
        if (chans[c] < 0 || chans[c] >= V)
            return 2;
    if (B == 0)
        return 0;
    if (n_threads < 1)
        n_threads = 1;
    if (n_threads > DLWP_MAX_THREADS)
        n_threads = DLWP_MAX_THREADS;
    if (n_threads > B)
        n_threads = (int)B;

    job_t jobs[DLWP_MAX_THREADS];
    pthread_t threads[DLWP_MAX_THREADS];
    const int64_t per = (B + n_threads - 1) / n_threads;
    int started = 0, err = 0;
    for (int i = 0; i < n_threads; i++) {
        job_t *j = &jobs[i];
        j->series = series;
        j->out = out;
        j->samples = samples;
        j->offsets = offsets;
        j->chans = chans;
        j->T = T;
        j->C = C;
        j->V = V;
        j->HW = HW;
        j->start_b = i * per < B ? i * per : B;
        j->end_b = (i + 1) * per < B ? (i + 1) * per : B;
        if (i == 0)
            continue;  /* the calling thread takes slice 0 */
        if (pthread_create(&threads[i], NULL, worker, j) != 0) {
            err = 3;
            break;
        }
        started = i;
    }
    worker(&jobs[0]);
    for (int i = 1; i <= started; i++)
        pthread_join(threads[i], NULL);
    return err;
}
