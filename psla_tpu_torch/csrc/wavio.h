// Shared declarations for the psla_tpu_torch native host runtime (csrc/).
#ifndef PSLA_TPU_CSRC_WAVIO_H_
#define PSLA_TPU_CSRC_WAVIO_H_

#include <cstdint>
#include <vector>

namespace pslanative {

// Decode channel 0 of a WAV file in full (no truncation).
// Returns 0 on success (error codes match wavio.cc constants).
int decode_full(const char* path, std::vector<float>* out, int32_t* rate);

}  // namespace pslanative

#endif  // PSLA_TPU_CSRC_WAVIO_H_
