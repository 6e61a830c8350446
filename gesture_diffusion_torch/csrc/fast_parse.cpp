// Host-side bulk float parser for BVH motion blocks (and any whitespace-
// separated float text): one C pass with strtod.  A copy of the JAX
// package's native/fast_parse.cpp; it is a host speed-up of the data
// loader, not a device kernel.
//
// Built at first use by gesture_diffusion_torch/native/__init__.py with
//   g++ -O3 -shared -fPIC fast_parse.cpp -o libfast_parse-<hash>.so
// into build/host/, and loaded with ctypes.
//
// Caveat: strtod honours LC_NUMERIC; callers run in the "C" locale.

#include <cstdlib>

extern "C" {

// Parse up to max_out whitespace-separated doubles from the
// null-terminated buffer s (len bytes, excluding the terminator).
// Returns the number parsed; stops early at the first non-numeric token.
long gdt_parse_floats(const char *s, long len, double *out, long max_out) {
    const char *p = s;
    const char *end = s + len;
    long n = 0;
    while (p < end && n < max_out) {
        while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' ||
                           *p == '\t')) {
            ++p;
        }
        if (p >= end) {
            break;
        }
        char *next;
        double v = strtod(p, &next);
        if (next == p) {
            break;
        }
        out[n++] = v;
        p = next;
    }
    return n;
}

}  // extern "C"
