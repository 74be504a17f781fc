// CRC32C (Castagnoli, polynomial 0x1EDC6F41 reflected = 0x82F63B78):
// the frame-integrity checksum the transport stamps on every frame
// header (net.h). Chosen over CRC32 (IEEE) for its strictly better
// error-detection properties on short messages and because it is the
// checksum the storage/networking world standardized on (iSCSI, ext4,
// leveldb) — a corrupted gradient frame must surface as a detected
// transport error, never as silently wrong arithmetic.
//
// Software slicing-by-8 implementation (~1-2 GB/s): runs everywhere the
// core builds, no ISA dispatch. Incremental: feed chunks via the `crc`
// parameter to checksum streamed payloads without buffering them.
#ifndef HVD_TPU_CHECKSUM_H
#define HVD_TPU_CHECKSUM_H

#include <cstddef>
#include <cstdint>

namespace hvdtpu {

// One-shot or incremental CRC32C. Start with crc=0; to extend a running
// checksum, pass the previous return value.
uint32_t Crc32c(const void* data, std::size_t len, uint32_t crc = 0);

}  // namespace hvdtpu

#endif  // HVD_TPU_CHECKSUM_H
