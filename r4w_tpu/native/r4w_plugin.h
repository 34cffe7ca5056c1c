/* r4w_tpu C-ABI waveform plugin interface.
 *
 * Re-design of crates/r4w-core/src/plugin/abi.rs (PluginInfo :45,
 * WaveformDescriptor :67, caps :88) for the JAX build: plugins are
 * shared libraries exporting the functions below; the Python
 * PluginManager loads them via ctypes and registers each waveform in
 * the factory. IQ crosses the boundary as interleaved f32 (re, im).
 *
 * Every exported string must point at static data.
 */

#ifndef R4W_TPU_PLUGIN_H
#define R4W_TPU_PLUGIN_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define R4W_PLUGIN_API_VERSION 1u

/* capability flags (plugin/abi.rs caps) */
#define R4W_CAP_CAN_MODULATE (1u << 0)
#define R4W_CAP_CAN_DEMODULATE (1u << 1)
#define R4W_CAP_HAS_VISUALIZATION (1u << 2)
#define R4W_CAP_SUPPORTS_STREAMING (1u << 3)

typedef struct {
    const char* name;
    const char* version;
    const char* description;
    const char* author;
    uint32_t waveform_count;
} R4wPluginInfo;

typedef struct {
    const char* id;
    const char* name;
    const char* description;
    double min_sample_rate;
    double max_sample_rate;
    uint32_t capabilities;
} R4wWaveformDescriptor;

/* required exports ---------------------------------------------------- */

uint32_t r4w_plugin_api_version(void);
const R4wPluginInfo* r4w_plugin_info(void);
/* array of length r4w_plugin_info()->waveform_count */
const R4wWaveformDescriptor* r4w_list_waveforms(void);

/* returns IQ sample count written, or -1 (unknown id / buffer too
 * small). iq_out is interleaved f32 re,im pairs. */
int64_t r4w_modulate(const char* id, double sample_rate,
                     const uint8_t* data, int64_t n_bytes,
                     float* iq_out, int64_t max_samples);

/* returns payload byte count written, or -1. */
int64_t r4w_demodulate(const char* id, double sample_rate,
                       const float* iq, int64_t n_samples,
                       uint8_t* out, int64_t max_bytes);

#ifdef __cplusplus
}
#endif

#endif /* R4W_TPU_PLUGIN_H */
