// The port's one addition to its copy of the native core (the other
// sources are copies of horovod_tpu/native/): the identity of this build,
// a hash of the sources and flags that horovod_tpu_torch/common/core.py
// passes at compile time and checks when it loads the library, so that a
// process that also loaded another build of the core can tell the two
// apart.

#ifndef HVD_TORCH_CORE_BUILD
#define HVD_TORCH_CORE_BUILD "unknown"
#endif

extern "C" const char* horovod_tpu_torch_core_build() {
  return HVD_TORCH_CORE_BUILD;
}
