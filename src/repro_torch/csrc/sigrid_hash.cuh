// The SigridHash mixer on uint32 lanes, shared by sigrid_hash.cu and
// fused_transform.cu (op SIGRID_HASH): xor-shift 16, multiply by
// 0x7FEB352D, xor-shift 15, multiply by 0x846CA68B, xor-shift 16 -- the
// reference's _hash_u32 (src/repro/kernels/sigrid_hash.py:17), all in
// uint32 arithmetic, so products wrap mod 2^32 and shifts are logical.
#pragma once
#include <stdint.h>

static __device__ __forceinline__ uint32_t sigrid_mix_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// hash(id ^ salt) % max_value, the uint32 result reinterpreted as int32
static __device__ __forceinline__ int32_t sigrid_hash_one(int32_t id, uint32_t salt,
                                                          uint32_t max_value) {
  return static_cast<int32_t>(sigrid_mix_u32(static_cast<uint32_t>(id) ^ salt) % max_value);
}
