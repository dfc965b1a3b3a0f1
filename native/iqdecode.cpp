// Native host-ingest kernels for kspecanal_tpu.
//
// The host-bound part of the pipeline is turning raw byte streams into the
// float32 IQ planes the device consumes (the rtl_sdr capture format:
// uint8 interleaved I/Q with a value-127 offset, octave/load_rtlsdr.m:8-13).
// At multi-Gsample/s device throughput the NumPy decode (two strided copies
// + cast + subtract) becomes the bottleneck, so it lives here as a single
// fused pass that GCC auto-vectorizes; threads split the stream for large
// captures.
//
// Exposed via ctypes (see kspecanal_tpu/io/native_iq.py); plain C ABI.

#include <cstdint>
#include <cstddef>
#include <thread>
#include <vector>

namespace {

void decode_span(const uint8_t* raw, float* re, float* im,
                 size_t start, size_t end) {
    for (size_t i = start; i < end; ++i) {
        re[i] = static_cast<float>(raw[2 * i]) - 127.0f;
        im[i] = static_cast<float>(raw[2 * i + 1]) - 127.0f;
    }
}

void split_span_u8(const uint8_t* raw, uint8_t* re, uint8_t* im,
                   size_t start, size_t end) {
    for (size_t i = start; i < end; ++i) {
        re[i] = raw[2 * i];
        im[i] = raw[2 * i + 1];
    }
}

}  // namespace

extern "C" {

// raw: 2*n bytes of interleaved I/Q; re/im: n floats out.
void iq_decode_u8(const uint8_t* raw, float* re, float* im, size_t n,
                  int num_threads) {
    if (num_threads <= 1 || n < (1u << 16)) {
        decode_span(raw, re, im, 0, n);
        return;
    }
    std::vector<std::thread> ts;
    size_t chunk = (n + num_threads - 1) / num_threads;
    for (int t = 0; t < num_threads; ++t) {
        size_t s = t * chunk;
        size_t e = s + chunk < n ? s + chunk : n;
        if (s >= e) break;
        ts.emplace_back(decode_span, raw, re, im, s, e);
    }
    for (auto& th : ts) th.join();
}

// Deinterleave RAW uint8 I/Q bytes into UNDECODED u8 planes (no value-127
// subtraction): the session's 2 B/sample ship path sends planes and the
// device program decodes them — splitting here keeps the strided
// deinterleave off the device on every raw path.
void iq_split_u8(const uint8_t* raw, uint8_t* re, uint8_t* im, size_t n,
                 int num_threads) {
    if (num_threads <= 1 || n < (1u << 18)) {
        split_span_u8(raw, re, im, 0, n);
        return;
    }
    std::vector<std::thread> ts;
    size_t chunk = (n + num_threads - 1) / num_threads;
    for (int t = 0; t < num_threads; ++t) {
        size_t s = t * chunk;
        size_t e = s + chunk < n ? s + chunk : n;
        if (s >= e) break;
        ts.emplace_back(split_span_u8, raw, re, im, s, e);
    }
    for (auto& th : ts) th.join();
}

// Deinterleave float32 complex pairs (re0,im0,re1,im1,...) into planes —
// used for pyrtlsdr-style complex128->complex64 host buffers.
void iq_split_f32(const float* interleaved, float* re, float* im, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        re[i] = interleaved[2 * i];
        im[i] = interleaved[2 * i + 1];
    }
}

}  // extern "C"
