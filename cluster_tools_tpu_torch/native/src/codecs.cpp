// Host codecs for the blosc chunk format (core/blosc.py frames them).
//
// zarr-python's default compressor, and what the JAX package writes for
// compression="blosc", is a Blosc1 frame of LZ4 streams over byte-shuffled
// blocks.  These are the per-stream codecs the frame needs, with a flat
// extern "C" API loaded via ctypes (native/__init__.py):
//
// * the LZ4 block format: compress (greedy, one hash probe per position,
//   LZ4's end-of-block rules) and decompress (bounds-checked);
// * BloscLZ: decompress only (the format of c-blosc 1.x's blosclz);
// * byte shuffle and unshuffle (element byte j of every element together).
//
// Every decoder returns the number of bytes written, or -1 on a corrupt or
// truncated stream; it never reads or writes out of bounds.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC codecs.cpp -o libctt_torch_codecs.so

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kMinMatch = 4;
constexpr int64_t kLastLiterals = 5;   // the last 5 bytes are literals
constexpr int64_t kMfLimit = 12;       // no match starts in the last 12
constexpr int kHashLog = 12;

inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint32_t hash4(uint32_t v) {
    return (v * 2654435761u) >> (32 - kHashLog);
}

// a length of ``n`` in LZ4's 4-bit-nibble-then-255s encoding (the nibble
// already holds 15)
inline uint8_t* put_length(uint8_t* op, int64_t n) {
    while (n >= 255) {
        *op++ = 255;
        n -= 255;
    }
    *op++ = static_cast<uint8_t>(n);
    return op;
}

// copy ``len`` bytes from ``ref`` (behind ``op``) forward, overlap allowed:
// the bytes repeat with period op - ref, so after one period the copy
// doubles what is already written
inline void copy_match(uint8_t* op, const uint8_t* ref, int64_t len) {
    const int64_t off = op - ref;
    if (off >= len) {
        std::memcpy(op, ref, len);
        return;
    }
    if (off == 1) {
        std::memset(op, *ref, len);
        return;
    }
    std::memcpy(op, ref, off);
    for (int64_t done = off; done < len;) {
        const int64_t n = done < len - done ? done : len - done;
        std::memcpy(op + done, op, n);
        done += n;
    }
}

}  // namespace

extern "C" {

// worst-case LZ4 output size for ``n`` input bytes
int64_t lz4_bound(int64_t n) { return n + n / 255 + 16; }

// LZ4 block compression of src[0:n] into dst (capacity >= lz4_bound(n));
// returns the compressed size.
int64_t lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                     int64_t cap) {
    if (cap < lz4_bound(n)) return -1;
    uint8_t* op = dst;
    int64_t anchor = 0;
    if (n >= kMfLimit + 1) {
        std::vector<int32_t> table(1 << kHashLog, -1);
        const int64_t mflimit = n - kMfLimit;
        const int64_t matchlimit = n - kLastLiterals;
        int64_t ip = 0;
        int64_t misses = 0;
        while (ip < mflimit) {
            const uint32_t seq = read32(src + ip);
            const uint32_t h = hash4(seq);
            const int64_t ref = table[h];
            table[h] = static_cast<int32_t>(ip);
            if (ref < 0 || ip - ref > 65535 || read32(src + ref) != seq) {
                // skip faster through incompressible stretches
                ip += 1 + (misses++ >> 6);
                continue;
            }
            misses = 0;
            int64_t ml = kMinMatch;
            while (ip + ml < matchlimit && src[ref + ml] == src[ip + ml]) ++ml;
            const int64_t lit = ip - anchor;
            const int64_t mcode = ml - kMinMatch;
            uint8_t* token = op++;
            *token = static_cast<uint8_t>(
                ((lit >= 15 ? 15 : lit) << 4) | (mcode >= 15 ? 15 : mcode));
            if (lit >= 15) op = put_length(op, lit - 15);
            std::memcpy(op, src + anchor, lit);
            op += lit;
            const int64_t off = ip - ref;
            *op++ = static_cast<uint8_t>(off & 0xff);
            *op++ = static_cast<uint8_t>(off >> 8);
            if (mcode >= 15) op = put_length(op, mcode - 15);
            ip += ml;
            anchor = ip;
            if (ip - 2 >= 0 && ip - 2 < mflimit)
                table[hash4(read32(src + ip - 2))] =
                    static_cast<int32_t>(ip - 2);
        }
    }
    const int64_t lit = n - anchor;
    *op++ = static_cast<uint8_t>((lit >= 15 ? 15 : lit) << 4);
    if (lit >= 15) op = put_length(op, lit - 15);
    std::memcpy(op, src + anchor, lit);
    op += lit;
    return op - dst;
}

// LZ4 block decompression of src[0:n] into dst[0:cap]; returns the bytes
// written or -1.
int64_t lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t cap) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    uint8_t* op = dst;
    uint8_t* const oend = dst + cap;
    while (ip < iend) {
        const uint8_t token = *ip++;
        int64_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                lit += b;
            } while (b == 255);
        }
        if (lit > iend - ip || lit > oend - op) return -1;
        std::memcpy(op, ip, lit);
        op += lit;
        ip += lit;
        if (ip >= iend) break;  // the last sequence has no match
        if (iend - ip < 2) return -1;
        const int64_t off = ip[0] | (ip[1] << 8);
        ip += 2;
        if (off == 0 || off > op - dst) return -1;
        int64_t ml = token & 15;
        if (ml == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                ml += b;
            } while (b == 255);
        }
        ml += kMinMatch;
        if (ml > oend - op) return -1;
        copy_match(op, op - off, ml);
        op += ml;
    }
    return op - dst;
}

// BloscLZ decompression (c-blosc 1.x) of src[0:n] into dst[0:cap]; returns
// the bytes written or -1.
int64_t blosclz_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                           int64_t cap) {
    constexpr int64_t kMaxDistance = 8191;
    if (n == 0) return 0;
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    uint8_t* op = dst;
    uint8_t* const oend = dst + cap;
    uint32_t ctrl = (*ip++) & 31u;
    while (true) {
        if (ctrl >= 32) {
            int64_t len = (ctrl >> 5) - 1;
            int64_t ofs = static_cast<int64_t>(ctrl & 31u) << 8;
            uint8_t code;
            if (len == 7 - 1) {
                do {
                    if (ip + 1 >= iend) return -1;
                    code = *ip++;
                    len += code;
                } while (code == 255);
            } else if (ip + 1 >= iend) {
                return -1;
            }
            code = *ip++;
            len += 3;
            int64_t back = ofs + code;  // ref = op - back - 1
            if (code == 255 && ofs == (31 << 8)) {
                if (ip + 1 >= iend) return -1;
                ofs = static_cast<int64_t>(ip[0]) << 8;
                ofs += ip[1];
                ip += 2;
                back = ofs + kMaxDistance;
            }
            if (len > oend - op) return -1;
            if (back + 1 > op - dst) return -1;
            const uint8_t* ref = op - back - 1;
            // as c-blosc: a stream that ends on a match drops it (encoders
            // always end on literals)
            if (ip >= iend) break;
            ctrl = *ip++;
            copy_match(op, ref, len);
            op += len;
        } else {
            const int64_t lit = ctrl + 1;
            if (lit > oend - op || lit > iend - ip) return -1;
            std::memcpy(op, ip, lit);
            op += lit;
            ip += lit;
            if (ip >= iend) break;
            ctrl = *ip++;
        }
    }
    return op - dst;
}

// byte shuffle of src[0:n] for elements of ``typesize`` bytes: byte j of
// element i goes to dst[j * (n / typesize) + i]; a tail of n % typesize
// bytes is copied as is
void byte_shuffle(const uint8_t* src, int64_t n, int64_t typesize,
                  uint8_t* dst) {
    const int64_t ne = n / typesize;
    for (int64_t j = 0; j < typesize; ++j) {
        uint8_t* out = dst + j * ne;
        const uint8_t* in = src + j;
        for (int64_t i = 0; i < ne; ++i) out[i] = in[i * typesize];
    }
    std::memcpy(dst + ne * typesize, src + ne * typesize, n - ne * typesize);
}

// the inverse of byte_shuffle
void byte_unshuffle(const uint8_t* src, int64_t n, int64_t typesize,
                    uint8_t* dst) {
    const int64_t ne = n / typesize;
    for (int64_t j = 0; j < typesize; ++j) {
        const uint8_t* in = src + j * ne;
        uint8_t* out = dst + j;
        for (int64_t i = 0; i < ne; ++i) out[i * typesize] = in[i];
    }
    std::memcpy(dst + ne * typesize, src + ne * typesize, n - ne * typesize);
}

}  // extern "C"
