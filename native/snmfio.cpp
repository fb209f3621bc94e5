// Native IO/runtime kernels for the se_snmf_nat_tpu framework.
//
// The reference's data path is MATLAB fread/fwrite of raw int16 streams with
// a 44-byte canonical wav header plus the hop-shift frame queue
// (filewise_run_IS16.m:92-167, pcm2wav.m:3-11).  This framework keeps
// that path off the device: these C++ kernels do the host-side byte work --
// wav parse/write, MATLAB-exact int16 quantization, stream framing, and
// overlap-add -- so the Python layer never loops over samples.  Exposed with
// a plain C ABI for ctypes (no pybind11 in the image).
//
// Build: make -C native   (g++ -O3 -march=native -shared -fPIC)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// MATLAB-exact int16 quantization: round half away from zero, saturate.
// (matlab_compat.matlab_int16_write)
// ---------------------------------------------------------------------------
void quantize_int16(const double* x, int16_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        double v = x[i];
        double r = (v >= 0.0) ? std::floor(v + 0.5) : std::ceil(v - 0.5);
        if (r > 32767.0) r = 32767.0;
        if (r < -32768.0) r = -32768.0;
        out[i] = (int16_t)r;
    }
}

// wavwrite 16-bit quantization: round(x*32768), saturate.
void wavwrite_quantize(const double* x, int16_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        double v = x[i] * 32768.0;
        double r = (v >= 0.0) ? std::floor(v + 0.5) : std::ceil(v - 0.5);
        if (r > 32767.0) r = 32767.0;
        if (r < -32768.0) r = -32768.0;
        out[i] = (int16_t)r;
    }
}

// ---------------------------------------------------------------------------
// Stream framing (dsp.stft.stream_frames): hop-shift queue semantics --
// frame l of the signal zero-prepended by (framelen - hop); n_flush zero
// frames appended.  frames must hold (n/hop + n_flush) * framelen doubles.
// Returns the number of frames written.
// ---------------------------------------------------------------------------
int64_t frame_stream(const double* x, int64_t n, int framelen, int hop,
                     int n_flush, double* frames) {
    int64_t n_hops = n / hop;
    int64_t pad = framelen - hop;
    for (int64_t t = 0; t < n_hops; ++t) {
        double* f = frames + t * framelen;
        int64_t start = t * hop - pad;  // signal index of frame sample 0
        for (int k = 0; k < framelen; ++k) {
            int64_t idx = start + k;
            f[k] = (idx >= 0 && idx < n_hops * hop) ? x[idx] : 0.0;
        }
    }
    std::memset(frames + n_hops * framelen, 0,
                sizeof(double) * (size_t)n_flush * framelen);
    return n_hops + n_flush;
}

// ---------------------------------------------------------------------------
// Overlap-add (dsp.stft.overlap_add): frame t covers [t*hop, t*hop+framelen).
// out must hold (t_frames-1)*hop + framelen doubles, zero-initialized here.
// ---------------------------------------------------------------------------
void overlap_add(const double* frames, int64_t t_frames, int framelen,
                 int hop, double* out) {
    int64_t total = (t_frames - 1) * (int64_t)hop + framelen;
    std::memset(out, 0, sizeof(double) * (size_t)total);
    for (int64_t t = 0; t < t_frames; ++t) {
        const double* f = frames + t * framelen;
        double* o = out + t * hop;
        for (int k = 0; k < framelen; ++k) o[k] += f[k];
    }
}

// ---------------------------------------------------------------------------
// Minimal canonical wav IO (16-bit PCM).  Matches the reference's 44-byte
// header skip + raw int16 semantics.  Returns 0 on success.
// ---------------------------------------------------------------------------
struct WavInfo { int32_t fs; int32_t channels; int64_t n_samples; };

static int read_header(FILE* f, WavInfo* info, int64_t* data_off,
                       int64_t* data_bytes) {
    char id[5] = {0};
    uint32_t sz;
    if (fread(id, 1, 4, f) != 4 || std::strncmp(id, "RIFF", 4)) return 1;
    if (fread(&sz, 4, 1, f) != 1) return 1;
    if (fread(id, 1, 4, f) != 4 || std::strncmp(id, "WAVE", 4)) return 1;
    uint16_t fmt = 0, ch = 0, bits = 0;
    uint32_t rate = 0;
    // chunk walk
    while (fread(id, 1, 4, f) == 4 && fread(&sz, 4, 1, f) == 1) {
        if (!std::strncmp(id, "fmt ", 4)) {
            uint8_t buf[64];
            uint32_t take = sz < 64 ? sz : 64;
            if (fread(buf, 1, take, f) != take) return 1;
            if (sz > take) fseek(f, (long)(sz - take), SEEK_CUR);
            std::memcpy(&fmt, buf, 2);
            std::memcpy(&ch, buf + 2, 2);
            std::memcpy(&rate, buf + 4, 4);
            std::memcpy(&bits, buf + 14, 2);
        } else if (!std::strncmp(id, "data", 4)) {
            *data_off = ftell(f);
            *data_bytes = sz;
            info->fs = (int32_t)rate;
            info->channels = ch;
            info->n_samples = (int64_t)sz / 2 / (ch ? ch : 1);
            return (fmt == 1 && bits == 16 && ch >= 1) ? 0 : 2;
        } else {
            fseek(f, (long)sz + (sz & 1), SEEK_CUR);
        }
    }
    return 1;
}

int wav_info(const char* path, int32_t* fs, int32_t* channels,
             int64_t* n_samples) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    WavInfo info;
    int64_t off, bytes;
    int rc = read_header(f, &info, &off, &bytes);
    fclose(f);
    if (rc) return rc;
    *fs = info.fs;
    *channels = info.channels;
    *n_samples = info.n_samples;
    return 0;
}

// Reads interleaved samples as doubles in int16 scale (MATLAB fread
// semantics); out must hold n_samples*channels doubles.
int wav_read_int16(const char* path, double* out) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    WavInfo info;
    int64_t off, bytes;
    int rc = read_header(f, &info, &off, &bytes);
    if (rc) { fclose(f); return rc; }
    fseek(f, (long)off, SEEK_SET);
    const int64_t CH = 1 << 16;
    int16_t buf[CH];
    // bound by what wav_info reported (floor-divided by channels): a data
    // chunk whose byte size is not a multiple of 2*channels must not write
    // past the caller's n_samples*channels buffer
    int64_t total = info.n_samples * info.channels, done = 0;
    while (done < total) {
        int64_t take = total - done < CH ? total - done : CH;
        size_t got = fread(buf, 2, (size_t)take, f);
        for (size_t i = 0; i < got; ++i) out[done + (int64_t)i] = buf[i];
        done += (int64_t)got;
        if ((int64_t)got < take) break;
    }
    fclose(f);
    return done == total ? 0 : 3;
}

int wav_write_int16(const char* path, const int16_t* x, int64_t n_samples,
                    int32_t fs, int32_t channels) {
    FILE* f = fopen(path, "wb");
    if (!f) return 1;
    uint32_t data_bytes = (uint32_t)(n_samples * channels * 2);
    uint32_t riff = 36 + data_bytes;
    uint16_t fmt = 1, ch = (uint16_t)channels, bits = 16,
             align = (uint16_t)(channels * 2);
    uint32_t rate = (uint32_t)fs, bps = rate * align, fmtsz = 16;
    fwrite("RIFF", 1, 4, f); fwrite(&riff, 4, 1, f);
    fwrite("WAVE", 1, 4, f); fwrite("fmt ", 1, 4, f);
    fwrite(&fmtsz, 4, 1, f); fwrite(&fmt, 2, 1, f); fwrite(&ch, 2, 1, f);
    fwrite(&rate, 4, 1, f); fwrite(&bps, 4, 1, f); fwrite(&align, 2, 1, f);
    fwrite(&bits, 2, 1, f); fwrite("data", 1, 4, f);
    fwrite(&data_bytes, 4, 1, f);
    size_t wrote = fwrite(x, 2, (size_t)(n_samples * channels), f);
    fclose(f);
    return wrote == (size_t)(n_samples * channels) ? 0 : 2;
}

// Full reference output chain in one call: float stream -> fwrite int16 ->
// /32767 -> wavwrite round(x*32768) -> wav file (write_enhanced_wav).
int wav_write_enhanced(const char* path, const double* x, int64_t n,
                       int32_t fs) {
    int16_t* pcm = (int16_t*)std::malloc(sizeof(int16_t) * (size_t)n);
    if (!pcm) return 4;
    quantize_int16(x, pcm, n);
    for (int64_t i = 0; i < n; ++i) {
        double v = (double)pcm[i] / 32767.0 * 32768.0;
        double r = (v >= 0.0) ? std::floor(v + 0.5) : std::ceil(v - 0.5);
        if (r > 32767.0) r = 32767.0;
        if (r < -32768.0) r = -32768.0;
        pcm[i] = (int16_t)r;
    }
    int rc = wav_write_int16(path, pcm, n, fs, 1);
    std::free(pcm);
    return rc;
}

}  // extern "C"
