/* r4w_capi.h — C API for the r4w_tpu framework's host-side DSP core.
 *
 * Batch-first counterpart of the reference's C FFI surface
 * (crates/r4w-ffi/src/lib.rs:1-1374, cbindgen header r4w.h): complex
 * I/Q helpers, FFT with peak search, LoRa chirp generation, a lock-free
 * SPSC ring buffer, signal utilities, and waveform handles
 * (BPSK/QPSK/LoRa) with modulate/demodulate.
 *
 * Design note: in this framework the accelerated compute path is
 * JAX/XLA on the accelerator; this library is the *embedded/host* seam — the same
 * algorithms in portable C++ so C callers (drivers, DAQ firmware,
 * test rigs) can frame and parse waveforms without a Python runtime.
 * Bit-exact conventions match the Python package (same Gray maps,
 * whitening LFSR, Hamming parities, chirp phase law), which
 * tests/test_capi.py cross-validates against the JAX implementations.
 * For accelerator-rate processing from C, stream IQ to a running
 * `r4w-tpu agent` over UDP/TCP instead (net.py wire format).
 *
 * Build:  g++ -O2 -shared -fPIC -o libr4w.so r4w_capi.cpp
 * Usage:
 *   #include "r4w_capi.h"
 *   r4w_waveform_t *wf = r4w_waveform_lora_new(7, 125000, 125000.0);
 *   size_t cap = r4w_waveform_modulate_size(wf, msg_len);
 *   r4w_complex_t *iq = malloc(cap * sizeof *iq);
 *   size_t n; r4w_waveform_modulate(wf, msg, msg_len, iq, cap, &n);
 */

#ifndef R4W_CAPI_H
#define R4W_CAPI_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ------------------------------------------------------------------ */
/* Types                                                               */
/* ------------------------------------------------------------------ */

/* Complex I/Q sample: layout-compatible with C99 double complex and
 * C++ std::complex<double>. */
typedef struct {
    double re;
    double im;
} r4w_complex_t;

typedef enum {
    R4W_OK = 0,
    R4W_NULL_POINTER = 1,
    R4W_INVALID_SIZE = 2,
    R4W_BUFFER_FULL = 3,
    R4W_BUFFER_EMPTY = 4,
    R4W_INVALID_PARAMETER = 5,
    R4W_ALLOCATION_FAILED = 6,
    R4W_NOT_SUPPORTED = 7,
} r4w_error_t;

typedef enum {
    R4W_WAVEFORM_BPSK = 0,
    R4W_WAVEFORM_QPSK = 1,
    R4W_WAVEFORM_LORA = 2,
} r4w_waveform_type_t;

typedef struct r4w_fft r4w_fft_t;
typedef struct r4w_chirp r4w_chirp_t;
typedef struct r4w_ringbuffer r4w_ringbuffer_t;
typedef struct r4w_waveform r4w_waveform_t;

/* ------------------------------------------------------------------ */
/* Version / init                                                      */
/* ------------------------------------------------------------------ */

const char *r4w_version(void);
int r4w_abi_version(void);
r4w_error_t r4w_init(void);

/* ------------------------------------------------------------------ */
/* Complex helpers                                                     */
/* ------------------------------------------------------------------ */

r4w_complex_t r4w_complex_new(double re, double im);
r4w_complex_t r4w_complex_from_polar(double magnitude, double phase);
double r4w_complex_magnitude(r4w_complex_t c);
double r4w_complex_phase(r4w_complex_t c);
double r4w_complex_power(r4w_complex_t c);
r4w_complex_t r4w_complex_conj(r4w_complex_t c);
r4w_complex_t r4w_complex_mul(r4w_complex_t a, r4w_complex_t b);
r4w_complex_t r4w_complex_add(r4w_complex_t a, r4w_complex_t b);

/* ------------------------------------------------------------------ */
/* FFT (any size; radix-2 fast path, Bluestein otherwise)              */
/* ------------------------------------------------------------------ */

r4w_fft_t *r4w_fft_new(size_t size);
void r4w_fft_free(r4w_fft_t *fft);
size_t r4w_fft_size(const r4w_fft_t *fft);
/* In-place transforms over `len == size` samples. Inverse is scaled
 * by 1/N (numpy/jnp.fft.ifft convention). */
r4w_error_t r4w_fft_forward(r4w_fft_t *fft, r4w_complex_t *buffer,
                            size_t len);
r4w_error_t r4w_fft_inverse(r4w_fft_t *fft, r4w_complex_t *buffer,
                            size_t len);
/* Magnitude peak over a spectrum (works on any buffer). */
r4w_error_t r4w_fft_find_peak(const r4w_complex_t *spectrum, size_t len,
                              size_t *bin, double *magnitude,
                              double *phase);
r4w_error_t r4w_fft_power_spectrum_db(const r4w_complex_t *input,
                                      double *output_db, size_t len);

/* ------------------------------------------------------------------ */
/* LoRa chirp generation (waveforms/lora/chirp.py phase law)           */
/* ------------------------------------------------------------------ */

/* spreading_factor 5..12; bandwidth_hz > 0; oversample >= 1. */
r4w_chirp_t *r4w_chirp_new(uint8_t spreading_factor,
                           uint32_t bandwidth_hz, size_t oversample);
void r4w_chirp_free(r4w_chirp_t *chirp);
size_t r4w_chirp_samples_per_symbol(const r4w_chirp_t *chirp);
double r4w_chirp_bandwidth(const r4w_chirp_t *chirp);
r4w_error_t r4w_chirp_generate_upchirp(const r4w_chirp_t *chirp,
                                       r4w_complex_t *buffer, size_t len);
r4w_error_t r4w_chirp_generate_downchirp(const r4w_chirp_t *chirp,
                                         r4w_complex_t *buffer,
                                         size_t len);
/* Symbol chirp = base upchirp cyclically rotated by symbol*oversample
 * samples (exact for integer symbols). */
r4w_error_t r4w_chirp_modulate_symbol(const r4w_chirp_t *chirp,
                                      uint16_t symbol,
                                      r4w_complex_t *buffer, size_t len);

/* ------------------------------------------------------------------ */
/* Lock-free SPSC ring buffer of complex samples                       */
/* ------------------------------------------------------------------ */

/* Capacity is rounded up to the next power of two; NULL if < 2. */
r4w_ringbuffer_t *r4w_ringbuffer_new(size_t capacity);
void r4w_ringbuffer_free(r4w_ringbuffer_t *rb);
size_t r4w_ringbuffer_capacity(const r4w_ringbuffer_t *rb);
size_t r4w_ringbuffer_len(const r4w_ringbuffer_t *rb);
int r4w_ringbuffer_is_empty(const r4w_ringbuffer_t *rb);
int r4w_ringbuffer_is_full(const r4w_ringbuffer_t *rb);
r4w_error_t r4w_ringbuffer_push(r4w_ringbuffer_t *rb, r4w_complex_t s);
r4w_error_t r4w_ringbuffer_pop(r4w_ringbuffer_t *rb, r4w_complex_t *out);
size_t r4w_ringbuffer_push_slice(r4w_ringbuffer_t *rb,
                                 const r4w_complex_t *data, size_t len);
size_t r4w_ringbuffer_pop_slice(r4w_ringbuffer_t *rb, r4w_complex_t *out,
                                size_t len);

/* ------------------------------------------------------------------ */
/* Signal utilities                                                    */
/* ------------------------------------------------------------------ */

r4w_error_t r4w_generate_tone(double frequency, double sample_rate,
                              r4w_complex_t *buffer, size_t len);
/* Deterministic AWGN at the given SNR (LCG + Box-Muller). */
r4w_error_t r4w_add_awgn(r4w_complex_t *buffer, size_t len,
                         double snr_db);
r4w_error_t r4w_frequency_shift(r4w_complex_t *buffer, size_t len,
                                double frequency_offset,
                                double sample_rate);

/* ------------------------------------------------------------------ */
/* Waveforms (r4w_tpu.waveforms parity: psk.py / lora/modem.py)        */
/* ------------------------------------------------------------------ */

r4w_waveform_t *r4w_waveform_bpsk_new(double sample_rate,
                                      double symbol_rate);
r4w_waveform_t *r4w_waveform_qpsk_new(double sample_rate,
                                      double symbol_rate);
/* sf 5..12, bandwidth in {125000, 250000, 500000}; sample_rate must be
 * an integer multiple of bandwidth (the oversample factor). */
r4w_waveform_t *r4w_waveform_lora_new(uint8_t spreading_factor,
                                      uint32_t bandwidth_hz,
                                      double sample_rate);
void r4w_waveform_free(r4w_waveform_t *wf);
r4w_waveform_type_t r4w_waveform_get_type(const r4w_waveform_t *wf);
size_t r4w_waveform_samples_per_symbol(const r4w_waveform_t *wf);
/* Static string; do not free. */
const char *r4w_waveform_name(const r4w_waveform_t *wf);

/* Worst-case sample count modulate() can emit for data_len bytes. */
size_t r4w_waveform_modulate_size(const r4w_waveform_t *wf,
                                  size_t data_len);
/* data bytes -> IQ. LoRa output includes the preamble (8 upchirps,
 * 2 sync chirps, 2.25 downchirps) followed by the payload chirps —
 * identical sample stream to waveforms/lora/modem.py modulate(). */
r4w_error_t r4w_waveform_modulate(const r4w_waveform_t *wf,
                                  const uint8_t *data, size_t data_len,
                                  r4w_complex_t *output,
                                  size_t output_len,
                                  size_t *samples_written);
/* IQ -> data bytes. PSK: nearest-point per symbol average, bits packed
 * MSB-first. LoRa: expects payload-aligned samples (preamble stripped),
 * runs dechirp-FFT-argmax then Gray/deinterleave/Hamming/dewhiten. */
r4w_error_t r4w_waveform_demodulate(const r4w_waveform_t *wf,
                                    const r4w_complex_t *samples,
                                    size_t samples_len, uint8_t *output,
                                    size_t output_len,
                                    size_t *bytes_written);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* R4W_CAPI_H */
