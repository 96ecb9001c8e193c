/* The host runner's dependent-load chase, compiled by the host C compiler
 * (core/probes/host_chase.py) and called through ctypes.
 *
 * Each load's address is the value the previous load returned, so the loads
 * cannot overlap and a step costs one load's latency at the level the
 * buffer lives in.  The final slot is returned so that the compiler must
 * keep every load of the chain. */
#include <stdint.h>

int32_t host_chase(const int32_t *perm, int64_t iters)
{
    int32_t x = 0;
    for (int64_t i = 0; i < iters; ++i)
        x = perm[x];
    return x;
}
