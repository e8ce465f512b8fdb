// Tabulate the x86 AVX reciprocal-square-root estimate (vrsqrtps) and
// prove which input bits it depends on.
//
//   gcc -O2 -mavx -o rsqrtps_table rsqrtps_table.c
//   ./rsqrtps_table > rsqrtps_table.txt
//
// XLA:CPU lowers lax.rsqrt to this estimate followed by two Newton
// steps (repro_torch/kernels/fp32.py emulates both).  The estimate is
// implementation-defined, so the table belongs to the CPU it was made
// on; the program prints that CPU's model beside it.
//
// Checks, over every positive normal float32 (exit 1 if any fails):
//   1. for x in [1, 4) the estimate depends only on the exponent's
//      parity and the top MANT_BITS mantissa bits;
//   2. for any exponent e, est(x) is the [1, 4) entry of the same parity
//      and mantissa with its exponent field lowered by (e - e_ref) / 2.
// The output lists the 2 * 2^MANT_BITS estimates as hex bit patterns:
// first x = 1 + m / 2^MANT_BITS (exponent field 127), then the same
// mantissas times 2 (exponent field 128).
#include <immintrin.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define MANT_BITS 10

static void est8(uint32_t first, uint32_t* out) {
  uint32_t in[8];
  for (int i = 0; i < 8; ++i) in[i] = first + (uint32_t)i;
  __m256 v = _mm256_loadu_ps((const float*)in);
  _mm256_storeu_ps((float*)out, _mm256_rsqrt_ps(v));
}

static void cpu_model(void) {
  FILE* f = fopen("/proc/cpuinfo", "r");
  char line[512];
  int family = -1, model = -1, stepping = -1;
  char name[256] = "unknown";
  if (f) {
    while (fgets(line, sizeof line, f)) {
      if (!strncmp(line, "model name", 10) && !strcmp(name, "unknown")) {
        char* p = strchr(line, ':');
        if (p) {
          snprintf(name, sizeof name, "%s", p + 2);
          name[strcspn(name, "\n")] = 0;
        }
      } else if (!strncmp(line, "cpu family", 10) && family < 0) {
        sscanf(strchr(line, ':') + 1, "%d", &family);
      } else if (!strncmp(line, "model\t", 6) && model < 0) {
        sscanf(strchr(line, ':') + 1, "%d", &model);
      } else if (!strncmp(line, "stepping", 8) && stepping < 0) {
        sscanf(strchr(line, ':') + 1, "%d", &stepping);
      }
    }
    fclose(f);
  }
  printf("# cpu: %s, family %d model %d stepping %d\n", name, family, model,
         stepping);
}

int main(void) {
  const uint32_t n = 1u << 23;
  uint32_t* ref = malloc(sizeof(uint32_t) * 2 * n);   // x in [1, 4)
  uint32_t got[8];
  for (uint32_t e = 127; e <= 128; ++e)
    for (uint32_t m = 0; m < n; m += 8) est8((e << 23) | m, ref + (e - 127) * n + m);
  const uint32_t low = (1u << (23 - MANT_BITS)) - 1;
  long bad = 0;
  for (uint32_t i = 0; i < 2 * n; ++i)
    if (ref[i] != ref[i & ~low]) ++bad;
  if (bad) {
    fprintf(stderr, "estimate depends on more than %d mantissa bits (%ld)\n",
            MANT_BITS, bad);
    return 1;
  }
  for (uint32_t e = 1; e <= 254; ++e) {
    const uint32_t par = (e - 127) & 1, eref = 127 + par;
    const int32_t shift = -((int32_t)e - (int32_t)eref) / 2;
    for (uint32_t m = 0; m < n; m += 8) {
      est8((e << 23) | m, got);
      for (int i = 0; i < 8; ++i) {
        const uint32_t r = ref[par * n + m + i];
        const uint32_t want = (uint32_t)((int32_t)r + shift * (1 << 23));
        if (got[i] != want) ++bad;
      }
    }
  }
  if (bad) {
    fprintf(stderr, "exponent scaling fails on %ld inputs\n", bad);
    return 1;
  }
  printf("# vrsqrtps estimate over [1, 4): %d rows per exponent parity "
         "(top %d mantissa bits); every positive normal float32 checked\n",
         1 << MANT_BITS, MANT_BITS);
  cpu_model();
  for (uint32_t p = 0; p < 2; ++p)
    for (uint32_t k = 0; k < (1u << MANT_BITS); ++k)
      printf("%08x\n", ref[p * n + (k << (23 - MANT_BITS))]);
  return 0;
}
