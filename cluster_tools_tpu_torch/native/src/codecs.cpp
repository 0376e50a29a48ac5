// Host codecs of the chunk formats the storage layer reads (core/blosc.py,
// core/codecs.py, core/storage.py and core/hdf5.py frame them).
//
// zarr-python's default compressor, and what the JAX package writes for
// compression="blosc", is a Blosc1 frame of LZ4 streams over byte-shuffled
// blocks.  Other writers (tensorstore, numcodecs, n5-zarr, h5py) use the
// other codecs below.  Each has a flat extern "C" API loaded via ctypes
// (native/__init__.py):
//
// * the LZ4 block format: compress (greedy, one hash probe per position,
//   LZ4's end-of-block rules) and decompress (bounds-checked);
// * BloscLZ: decompress only (the format of c-blosc 1.x's blosclz);
// * Zstandard frames (RFC 8878): decompress every block and literal
//   type, FSE and Huffman tables, repeat offsets, the XXH64 content
//   checksum, skippable frames (no dictionaries); compress into stored
//   frames of RLE and raw blocks with the content size and checksum (the
//   chunks of an orbax checkpoint, models/orbax.py);
// * Snappy's raw format and liblzf's format (h5py's LZF filter):
//   decompress only;
// * byte shuffle and unshuffle (element byte j of every element together),
//   and the bitshuffle of c-blosc (bit k of byte j of every element
//   together, over groups of 8 elements);
// * Jenkins' lookup3 hash, the checksum of HDF5's metadata;
// * CRC-32C (Castagnoli), the checksum of tensorstore's OCDBT manifests
//   and nodes.
//
// Every decoder returns the number of bytes written, or a negative code on
// a corrupt or truncated stream; it never reads or writes out of bounds.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC codecs.cpp -o libctt_torch_codecs.so

#include <cstdint>
#include <cstring>
#include <new>
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

// ---------------------------------------------------------------------------
// Zstandard (RFC 8878)
// ---------------------------------------------------------------------------

namespace {
namespace zstd {

constexpr int kCorrupt = -1;    // malformed or truncated input
constexpr int kDictionary = -2; // the frame names a dictionary
constexpr int kChecksum = -3;   // the content checksum does not match
constexpr int kTooLarge = -4;   // the content does not fit the output
constexpr int64_t kBlockMax = 1 << 17;

struct Fail {
    int code;
};

[[noreturn]] inline void fail(int code = kCorrupt) { throw Fail{code}; }

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

inline uint32_t le32(const uint8_t* p) {
    return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

// the bits of an FSE table description, least significant bit first
struct ForwardBits {
    const uint8_t* p;
    int64_t n;
    int64_t bit = 0;
    uint32_t peek(int nb) const {
        uint64_t v = 0;
        const int64_t at = bit >> 3;
        for (int i = 0; i < 5 && at + i < n; ++i)
            v |= uint64_t(p[at + i]) << (8 * i);
        return uint32_t((v >> (bit & 7)) & ((1ull << nb) - 1));
    }
};

// a backward bit stream: read from the highest bit below the final byte's
// marker bit down to bit 0; bits below 0 read as zeros (``pos`` < 0 marks
// the overflow the format uses to end the Huffman weights)
struct BackBits {
    const uint8_t* p = nullptr;
    int64_t n = 0;
    int64_t pos = 0;
    void init(const uint8_t* src, int64_t len) {
        if (len <= 0 || src[len - 1] == 0) fail();
        p = src;
        n = len;
        pos = (len - 1) * 8 + highbit(src[len - 1]);
    }
    uint64_t window(int64_t lo, int nb) const {
        const int64_t at = lo >> 3;
        uint64_t v = 0;
        if (at + 8 <= n) {
            std::memcpy(&v, p + at, 8);
        } else {
            for (int64_t i = 0; at + i < n; ++i) v |= uint64_t(p[at + i]) << (8 * i);
        }
        return (v >> (lo & 7)) & ((1ull << nb) - 1);
    }
    uint64_t peek(int nb) const {
        if (nb == 0) return 0;
        const int64_t lo = pos - nb;
        if (lo >= 0) return window(lo, nb);
        if (pos <= 0) return 0;
        return window(0, int(pos)) << (-lo);
    }
    uint64_t read(int nb) {
        const uint64_t v = peek(nb);
        pos -= nb;
        return v;
    }
};

struct FseEntry {
    uint16_t symbol;
    uint16_t base;
    uint8_t nbits;
};

struct Fse {
    int acc_log = -1;  // -1: no table yet (a repeat mode then is corrupt)
    std::vector<FseEntry> t;
};

// the decoding table of a normalized distribution (RFC 8878 4.1.1)
void build_fse(Fse& f, const int16_t* norm, int max_sym, int acc_log) {
    const int size = 1 << acc_log;
    f.acc_log = acc_log;
    f.t.assign(size, FseEntry{0, 0, 0});
    std::vector<uint32_t> next(max_sym + 1, 0);
    int high = size - 1;
    for (int s = 0; s <= max_sym; ++s) {
        if (norm[s] == -1) {
            if (high < 0) fail();
            f.t[high--].symbol = uint16_t(s);
            next[s] = 1;
        }
    }
    const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    int pos = 0;
    for (int s = 0; s <= max_sym; ++s) {
        if (norm[s] <= 0) continue;
        next[s] = uint32_t(norm[s]);
        for (int i = 0; i < norm[s]; ++i) {
            f.t[pos].symbol = uint16_t(s);
            do {
                pos = (pos + step) & mask;
            } while (pos > high);
        }
    }
    if (pos != 0) fail();
    for (int u = 0; u < size; ++u) {
        const uint32_t x = next[f.t[u].symbol]++;
        if (x == 0) fail();
        const int nb = acc_log - highbit(x);
        f.t[u].nbits = uint8_t(nb);
        f.t[u].base = uint16_t((x << nb) - size);
    }
}

void rle_fse(Fse& f, int symbol) {
    f.acc_log = 0;
    f.t.assign(1, FseEntry{uint16_t(symbol), 0, 0});
}

// an FSE table description at p[0:n]; returns the bytes it took
int64_t read_fse(const uint8_t* p, int64_t n, int max_acc, int max_sym,
                 Fse& f) {
    if (n < 1) fail();
    int16_t norm[256];
    ForwardBits b{p, n};
    const int acc_log = int(b.peek(4)) + 5;
    b.bit += 4;
    if (acc_log > max_acc) fail();
    int remaining = (1 << acc_log) + 1, threshold = 1 << acc_log;
    int nbits = acc_log + 1, sym = 0;
    bool prev0 = false;
    while (remaining > 1 && sym <= max_sym) {
        if (prev0) {
            int n0 = sym;
            while (true) {
                const int r = int(b.peek(2));
                b.bit += 2;
                n0 += r;
                if (r != 3) break;
                if (b.bit > 8 * n) fail();
            }
            if (n0 > max_sym) fail();
            while (sym < n0) norm[sym++] = 0;
        }
        const int max = (2 * threshold - 1) - remaining;
        const int v = int(b.peek(nbits));
        int count;
        if ((v & (threshold - 1)) < max) {
            count = v & (threshold - 1);
            b.bit += nbits - 1;
        } else {
            count = v & (2 * threshold - 1);
            if (count >= threshold) count -= max;
            b.bit += nbits;
        }
        --count;  // 0 stands for the probability "less than 1" (-1)
        remaining -= count < 0 ? -count : count;
        norm[sym++] = int16_t(count);
        prev0 = count == 0;
        if (b.bit > 8 * n) fail();
        if (remaining < threshold) {
            if (remaining <= 1) break;
            nbits = highbit(uint32_t(remaining)) + 1;
            threshold = 1 << (nbits - 1);
        }
    }
    if (remaining != 1 || sym == 0) fail();
    build_fse(f, norm, sym - 1, acc_log);
    return (b.bit + 7) >> 3;
}

struct Huffman {
    int max_bits = 0;  // 0: no table yet (treeless literals are corrupt)
    std::vector<uint16_t> entry;  // symbol << 4 | code length
};

// a Huffman tree description at p[0:n]; returns the bytes it took
int64_t read_huffman(const uint8_t* p, int64_t n, Huffman& h) {
    if (n < 1) fail();
    uint8_t w[256] = {0};
    int nw = 0;
    int64_t used;
    const int hb = p[0];
    if (hb < 128) {  // FSE-compressed weights, two interleaved states
        if (hb == 0 || 1 + hb > n) fail();
        Fse f;
        const int64_t desc = read_fse(p + 1, hb, 6, 255, f);
        if (desc >= hb) fail();
        BackBits b;
        b.init(p + 1 + desc, hb - desc);
        uint32_t s1 = uint32_t(b.read(f.acc_log));
        uint32_t s2 = uint32_t(b.read(f.acc_log));
        while (true) {
            if (nw > 253) fail();
            w[nw++] = uint8_t(f.t[s1].symbol);
            s1 = f.t[s1].base + uint32_t(b.read(f.t[s1].nbits));
            if (b.pos < 0) {
                w[nw++] = uint8_t(f.t[s2].symbol);
                break;
            }
            if (nw > 253) fail();
            w[nw++] = uint8_t(f.t[s2].symbol);
            s2 = f.t[s2].base + uint32_t(b.read(f.t[s2].nbits));
            if (b.pos < 0) {
                w[nw++] = uint8_t(f.t[s1].symbol);
                break;
            }
        }
        used = 1 + hb;
    } else {  // 4-bit weights, two per byte, the first in the high nibble
        nw = hb - 127;
        const int64_t nb = (nw + 1) / 2;
        if (1 + nb > n) fail();
        for (int i = 0; i < nw; ++i)
            w[i] = (i % 2 == 0) ? p[1 + i / 2] >> 4 : p[1 + i / 2] & 15;
        used = 1 + nb;
    }
    uint32_t total = 0;
    for (int i = 0; i < nw; ++i) {
        if (w[i] > 11) fail();
        if (w[i]) total += 1u << (w[i] - 1);
    }
    if (total == 0) fail();
    const int max_bits = highbit(total) + 1;
    if (max_bits > 11) fail();
    const uint32_t left = (1u << max_bits) - total;
    if (left == 0 || (left & (left - 1))) fail();
    w[nw] = uint8_t(highbit(left) + 1);  // the last symbol's weight
    const int ns = nw + 1;
    uint32_t rank[13] = {0}, start[13] = {0};
    for (int s = 0; s < ns; ++s) ++rank[w[s]];
    uint32_t next = 0;
    for (int k = 1; k <= max_bits; ++k) {
        start[k] = next;
        next += rank[k] << (k - 1);
    }
    h.max_bits = max_bits;
    h.entry.assign(size_t(1) << max_bits, 0);
    for (int s = 0; s < ns; ++s) {
        const int k = w[s];
        if (!k) continue;
        const uint16_t e = uint16_t((s << 4) | (max_bits + 1 - k));
        const uint32_t len = 1u << (k - 1);
        for (uint32_t i = 0; i < len; ++i) h.entry[start[k] + i] = e;
        start[k] += len;
    }
    return used;
}

void huffman_stream(const Huffman& h, const uint8_t* p, int64_t n,
                    uint8_t* out, int64_t count) {
    BackBits b;
    b.init(p, n);
    for (int64_t i = 0; i < count; ++i) {
        const uint16_t e = h.entry[b.peek(h.max_bits)];
        out[i] = uint8_t(e >> 4);
        b.pos -= e & 15;
    }
    if (b.pos != 0) fail();
}

const uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10,  11,   12,   13,   14,   15,   16,    18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,  14,  15,  16,   17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,  32,  33,  34,   35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,  1,  1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// what carries from one block of a frame to the next
struct FrameState {
    Huffman huffman;
    Fse ll, of, ml;
    uint64_t rep[3] = {1, 4, 8};
    std::vector<uint8_t> lit;
};

// the literals section at p[0:n] into st.lit; returns the bytes it took
int64_t read_literals(const uint8_t* p, int64_t n, FrameState& st) {
    if (n < 1) fail();
    const int type = p[0] & 3, fmt = (p[0] >> 2) & 3;
    int64_t regen, comp = 0, head;
    if (type < 2) {
        if (fmt == 0 || fmt == 2) {
            head = 1;
            regen = p[0] >> 3;
        } else if (fmt == 1) {
            head = 2;
            if (n < 2) fail();
            regen = (p[0] >> 4) | (p[1] << 4);
        } else {
            head = 3;
            if (n < 3) fail();
            regen = (p[0] >> 4) | (p[1] << 4) | (int64_t(p[2]) << 12);
        }
    } else {
        head = fmt < 2 ? 3 : fmt + 2;
        if (n < head) fail();
        uint64_t c = 0;
        for (int i = 0; i < head; ++i) c |= uint64_t(p[i]) << (8 * i);
        const int width = fmt < 2 ? 10 : (fmt == 2 ? 14 : 18);
        regen = int64_t((c >> 4) & ((1u << width) - 1));
        comp = int64_t((c >> (4 + width)) & ((1u << width) - 1));
    }
    if (regen > kBlockMax) fail();
    st.lit.resize(size_t(regen));
    if (type == 0) {
        if (head + regen > n) fail();
        if (regen) std::memcpy(st.lit.data(), p + head, size_t(regen));
        return head + regen;
    }
    if (type == 1) {
        if (head + 1 > n) fail();
        std::memset(st.lit.data(), p[head], size_t(regen));
        return head + 1;
    }
    if (head + comp > n) fail();
    const uint8_t* ip = p + head;
    int64_t left = comp;
    if (type == 2) {
        const int64_t t = read_huffman(ip, left, st.huffman);
        ip += t;
        left -= t;
    } else if (st.huffman.max_bits == 0) {
        fail();  // treeless literals with no earlier table
    }
    if (fmt == 0) {  // one stream
        huffman_stream(st.huffman, ip, left, st.lit.data(), regen);
    } else {  // four streams behind a jump table of three sizes
        if (left < 6) fail();
        const int64_t s1 = ip[0] | (ip[1] << 8), s2 = ip[2] | (ip[3] << 8),
                      s3 = ip[4] | (ip[5] << 8);
        const int64_t s4 = left - 6 - s1 - s2 - s3;
        if (s4 < 1) fail();
        const int64_t part = (regen + 3) / 4;
        if (3 * part > regen) fail();
        const uint8_t* q = ip + 6;
        uint8_t* o = st.lit.data();
        huffman_stream(st.huffman, q, s1, o, part);
        huffman_stream(st.huffman, q + s1, s2, o + part, part);
        huffman_stream(st.huffman, q + s1 + s2, s3, o + 2 * part, part);
        huffman_stream(st.huffman, q + s1 + s2 + s3, s4, o + 3 * part,
                       regen - 3 * part);
    }
    return head + comp;
}

// one symbol table of the sequences section (mode 0-3); returns its bytes
int64_t read_table(int mode, const uint8_t* p, int64_t n, Fse& f,
                   const int16_t* def, int def_max, int def_acc, int max_acc,
                   int max_sym) {
    if (mode == 0) {
        build_fse(f, def, def_max, def_acc);
        return 0;
    }
    if (mode == 1) {
        if (n < 1 || p[0] > max_sym) fail();
        rle_fse(f, p[0]);
        return 1;
    }
    if (mode == 2) return read_fse(p, n, max_acc, max_sym, f);
    if (f.acc_log < 0) fail();  // repeat with no earlier table
    return 0;
}

// copy ``len`` bytes from ``back`` bytes behind ``op`` (overlap allowed)
inline void copy_back(uint8_t* op, int64_t back, int64_t len) {
    copy_match(op, op - back, len);
}

// one compressed block at p[0:n], appended at op; returns the new op
uint8_t* compressed_block(const uint8_t* p, int64_t n, FrameState& st,
                          uint8_t* frame_start, uint8_t* op, uint8_t* oend) {
    const uint8_t* const block_out = op;
    int64_t used = read_literals(p, n, st);
    const uint8_t* ip = p + used;
    const uint8_t* const iend = p + n;
    if (ip >= iend) fail();
    int64_t nseq = ip[0];
    if (nseq < 128) {
        ip += 1;
    } else if (nseq < 255) {
        if (iend - ip < 2) fail();
        nseq = ((nseq - 128) << 8) + ip[1];
        ip += 2;
    } else {
        if (iend - ip < 3) fail();
        nseq = ip[1] + (ip[2] << 8) + 0x7F00;
        ip += 3;
    }
    const uint8_t* lit = st.lit.data();
    const uint8_t* const lit_end = lit + st.lit.size();
    if (nseq > 0) {
        if (ip >= iend) fail();
        const int modes = *ip++;
        if (modes & 3) fail();
        ip += read_table(modes >> 6, ip, iend - ip, st.ll, kLLDefault, 35, 6, 9,
                         35);
        ip += read_table((modes >> 4) & 3, ip, iend - ip, st.of, kOFDefault, 28,
                         5, 8, 31);
        ip += read_table((modes >> 2) & 3, ip, iend - ip, st.ml, kMLDefault, 52,
                         6, 9, 52);
        if (ip >= iend) fail();
        BackBits b;
        b.init(ip, iend - ip);
        uint32_t sll = uint32_t(b.read(st.ll.acc_log));
        uint32_t sof = uint32_t(b.read(st.of.acc_log));
        uint32_t sml = uint32_t(b.read(st.ml.acc_log));
        uint64_t* rep = st.rep;
        for (int64_t i = 0; i < nseq; ++i) {
            const int ofc = st.of.t[sof].symbol, mlc = st.ml.t[sml].symbol,
                      llc = st.ll.t[sll].symbol;
            if (ofc > 31 || mlc > 52 || llc > 35) fail();
            const uint64_t ofv = (1ull << ofc) + b.read(ofc);
            const int64_t ml = kMLBase[mlc] + int64_t(b.read(kMLBits[mlc]));
            const int64_t ll = kLLBase[llc] + int64_t(b.read(kLLBits[llc]));
            uint64_t off;
            if (ofv > 3) {
                off = ofv - 3;
                rep[2] = rep[1];
                rep[1] = rep[0];
                rep[0] = off;
            } else {
                const int idx = int(ofv) - 1 + (ll == 0 ? 1 : 0);
                if (idx == 0) {
                    off = rep[0];
                } else {
                    off = idx == 3 ? rep[0] - 1 : rep[idx];
                    if (off == 0) fail();
                    if (idx > 1) rep[2] = rep[1];
                    rep[1] = rep[0];
                    rep[0] = off;
                }
            }
            if (ll > lit_end - lit) fail();
            if (ll > oend - op) fail(kTooLarge);
            if (ll) std::memcpy(op, lit, size_t(ll));
            op += ll;
            lit += ll;
            if (off > uint64_t(op - frame_start)) fail();
            if (ml > oend - op) fail(kTooLarge);
            copy_back(op, int64_t(off), ml);
            op += ml;
            if (i + 1 < nseq) {
                sll = st.ll.t[sll].base + uint32_t(b.read(st.ll.t[sll].nbits));
                sml = st.ml.t[sml].base + uint32_t(b.read(st.ml.t[sml].nbits));
                sof = st.of.t[sof].base + uint32_t(b.read(st.of.t[sof].nbits));
            }
        }
        if (b.pos != 0) fail();
    } else if (ip != iend) {
        fail();
    }
    const int64_t rest = lit_end - lit;
    if (rest > oend - op) fail(kTooLarge);
    if (rest) std::memcpy(op, lit, size_t(rest));
    op += rest;
    if (op - block_out > kBlockMax) fail();
    return op;
}

// XXH64 (seed 0) of p[0:n]
uint64_t xxh64(const uint8_t* p, int64_t n) {
    constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                       P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                       P5 = 2870177450012600261ull;
    auto rotl = [](uint64_t x, int r) { return (x << r) | (x >> (64 - r)); };
    auto round = [&](uint64_t acc, uint64_t in) {
        acc += in * P2;
        acc = rotl(acc, 31);
        return acc * P1;
    };
    auto read64 = [](const uint8_t* q) {
        uint64_t v;
        std::memcpy(&v, q, 8);
        return v;
    };
    const uint8_t* const end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
        const uint8_t* const limit = end - 32;
        do {
            v1 = round(v1, read64(p));
            v2 = round(v2, read64(p + 8));
            v3 = round(v3, read64(p + 16));
            v4 = round(v4, read64(p + 24));
            p += 32;
        } while (p <= limit);
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        for (uint64_t v : {v1, v2, v3, v4}) {
            h ^= round(0, v);
            h = h * P1 + P4;
        }
    } else {
        h = P5;
    }
    h += uint64_t(n);
    while (end - p >= 8) {
        h ^= round(0, read64(p));
        h = rotl(h, 27) * P1 + P4;
        p += 8;
    }
    if (end - p >= 4) {
        h ^= uint64_t(le32(p)) * P1;
        h = rotl(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= uint64_t(*p++) * P5;
        h = rotl(h, 11) * P1;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

// one frame at src[0:n] appended at op; returns the bytes of src it took
int64_t frame(const uint8_t* src, int64_t n, uint8_t*& op, uint8_t* oend) {
    if (n < 5) fail();
    const uint8_t fhd = src[4];
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1,
              checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
    if (fhd & 0x08) fail();  // reserved bit
    int64_t pos = 5;
    if (!single) ++pos;  // the window descriptor: a one-buffer decoder
                         // needs only the offsets' bound below
    const int dict_bytes[4] = {0, 1, 2, 4};
    if (pos + dict_bytes[dict_flag] > n) fail();
    uint32_t dict = 0;
    for (int i = 0; i < dict_bytes[dict_flag]; ++i)
        dict |= uint32_t(src[pos + i]) << (8 * i);
    pos += dict_bytes[dict_flag];
    if (dict != 0) fail(kDictionary);
    const int fcs_bytes[4] = {single ? 1 : 0, 2, 4, 8};
    const int fb = fcs_bytes[fcs_flag];
    if (pos + fb > n) fail();
    int64_t content = -1;
    if (fb) {
        uint64_t v = 0;
        for (int i = 0; i < fb; ++i) v |= uint64_t(src[pos + i]) << (8 * i);
        if (fb == 2) v += 256;
        if (v > uint64_t(INT64_MAX)) fail(kTooLarge);
        content = int64_t(v);
        if (content > oend - op) fail(kTooLarge);
    }
    pos += fb;
    uint8_t* const frame_start = op;
    FrameState st;
    while (true) {
        if (pos + 3 > n) fail();
        const uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
        pos += 3;
        const int last = bh & 1, type = (bh >> 1) & 3;
        const int64_t size = bh >> 3;
        if (type == 0) {  // raw
            if (size > kBlockMax) fail();
            if (pos + size > n) fail();
            if (size > oend - op) fail(kTooLarge);
            std::memcpy(op, src + pos, size_t(size));
            op += size;
            pos += size;
        } else if (type == 1) {  // RLE
            if (size > kBlockMax) fail();
            if (pos + 1 > n) fail();
            if (size > oend - op) fail(kTooLarge);
            std::memset(op, src[pos], size_t(size));
            op += size;
            pos += 1;
        } else if (type == 2) {  // compressed
            if (size > kBlockMax || pos + size > n) fail();
            op = compressed_block(src + pos, size, st, frame_start, op, oend);
            pos += size;
        } else {
            fail();
        }
        if (last) break;
    }
    if (content >= 0 && op - frame_start != content) fail();
    if (checksum) {
        if (pos + 4 > n) fail();
        const uint32_t want = le32(src + pos);
        if (uint32_t(xxh64(frame_start, op - frame_start)) != want)
            fail(kChecksum);
        pos += 4;
    }
    return pos;
}

// the most bytes compress() writes for n plain bytes: magic, header
// descriptor, window descriptor, content size, one header per block (an
// empty input has one empty block), the bytes, the checksum
int64_t compress_bound(int64_t n) {
    return 4 + 1 + 1 + 8 + 3 * (n / kBlockMax + 1) + n + 4;
}

inline uint8_t* put_le(uint8_t* op, uint64_t v, int bytes) {
    for (int i = 0; i < bytes; ++i) *op++ = uint8_t(v >> (8 * i));
    return op;
}

// one frame of src[0:n] at dst: an RLE block where a block is one byte
// repeated, a raw block otherwise, each at most kBlockMax bytes.  The
// header states the content size; up to kBlockMax bytes the frame is a
// single segment (its window is its content), beyond it the window is
// kBlockMax, all a frame of raw and RLE blocks needs.  The frame ends in
// the low 32 bits of the content's XXH64.
int64_t compress(const uint8_t* src, int64_t n, uint8_t* dst) {
    uint8_t* op = put_le(dst, 0xFD2FB528u, 4);
    const bool single = n <= kBlockMax;
    int fcs_flag, fcs_bytes;
    uint64_t fcs = uint64_t(n);
    if (single && n < 256) {
        fcs_flag = 0, fcs_bytes = 1;
    } else if (single && n < 65536 + 256) {
        fcs_flag = 1, fcs_bytes = 2, fcs -= 256;
    } else if (n <= int64_t(UINT32_MAX)) {
        fcs_flag = 2, fcs_bytes = 4;
    } else {
        fcs_flag = 3, fcs_bytes = 8;
    }
    *op++ = uint8_t(fcs_flag << 6 | int(single) << 5 | 1 << 2);
    if (!single) *op++ = uint8_t((17 - 10) << 3);  // window 2^17
    op = put_le(op, fcs, fcs_bytes);
    int64_t at = 0;
    do {
        const int64_t size = n - at < kBlockMax ? n - at : kBlockMax;
        const uint8_t* p = src + at;
        const bool rle = size > 1 && std::memcmp(p, p + 1, size_t(size - 1)) == 0;
        at += size;
        op = put_le(op, uint64_t(at == n) | uint64_t(rle ? 1 : 0) << 1 |
                            uint64_t(size) << 3, 3);
        if (rle) {
            *op++ = p[0];
        } else {
            if (size) std::memcpy(op, p, size_t(size));
            op += size;
        }
    } while (at < n);
    op = put_le(op, uint32_t(xxh64(src, n)), 4);
    return op - dst;
}

}  // namespace zstd

inline uint64_t rd64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
}

// the 8x8 bit matrix transpose of bitshuffle's TRANS_BIT_8X8: bit j of
// byte k goes to bit k of byte j
inline uint64_t transpose_bits(uint64_t x) {
    uint64_t t;
    t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
    x = x ^ t ^ (t << 7);
    t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
    x = x ^ t ^ (t << 14);
    t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
    x = x ^ t ^ (t << 28);
    return x;
}

}  // namespace

extern "C" {

// Zstandard decompression of the frames at src[0:n] (skippable frames
// skipped) into dst[0:cap]; returns the bytes written, or -1 (corrupt),
// -2 (a dictionary is named), -3 (checksum mismatch), -4 (does not fit)
int64_t zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap) {
    uint8_t* op = dst;
    try {
        int64_t pos = 0;
        if (n < 4) zstd::fail();
        while (pos < n) {
            if (n - pos < 4) zstd::fail();
            const uint32_t magic = zstd::le32(src + pos);
            if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
                if (n - pos < 8) zstd::fail();
                const int64_t size = zstd::le32(src + pos + 4);
                if (size > n - pos - 8) zstd::fail();
                pos += 8 + size;
            } else if (magic == 0xFD2FB528u) {
                pos += zstd::frame(src + pos, n - pos, op, dst + cap);
            } else {
                zstd::fail();
            }
        }
    } catch (const zstd::Fail& e) {
        return e.code;
    } catch (const std::bad_alloc&) {
        return zstd::kCorrupt;
    }
    return op - dst;
}

// the most bytes zstd_compress writes for n plain bytes
int64_t zstd_bound(int64_t n) { return zstd::compress_bound(n); }

// one Zstandard frame of src[0:n] (RLE and raw blocks, the content size,
// the XXH64 checksum) into dst[0:cap]; returns the bytes written, or -4
// when cap is below zstd_bound(n)
int64_t zstd_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                      int64_t cap) {
    if (n < 0 || cap < zstd::compress_bound(n)) return zstd::kTooLarge;
    return zstd::compress(src, n, dst);
}

// Snappy raw-format decompression of src[0:n] into dst[0:cap]; returns
// the bytes written or -1
int64_t snappy_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                          int64_t cap) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    uint64_t length = 0;
    for (int shift = 0;; shift += 7) {
        if (ip >= iend || shift > 28) return -1;
        const uint8_t c = *ip++;
        length |= uint64_t(c & 0x7f) << shift;
        if (!(c & 0x80)) break;
    }
    if (length > uint64_t(cap)) return -1;
    uint8_t* op = dst;
    uint8_t* const oend = dst + length;
    while (ip < iend) {
        const uint8_t tag = *ip++;
        const int kind = tag & 3;
        if (kind == 0) {
            int64_t len = tag >> 2;
            if (len >= 60) {
                const int nb = int(len) - 59;
                if (iend - ip < nb) return -1;
                len = 0;
                for (int i = 0; i < nb; ++i) len |= int64_t(ip[i]) << (8 * i);
                ip += nb;
            }
            ++len;
            if (len > iend - ip || len > oend - op) return -1;
            std::memcpy(op, ip, size_t(len));
            op += len;
            ip += len;
            continue;
        }
        int64_t len, off;
        if (kind == 1) {
            if (ip >= iend) return -1;
            len = 4 + ((tag >> 2) & 7);
            off = (int64_t(tag >> 5) << 8) | *ip++;
        } else if (kind == 2) {
            if (iend - ip < 2) return -1;
            len = 1 + (tag >> 2);
            off = ip[0] | (ip[1] << 8);
            ip += 2;
        } else {
            if (iend - ip < 4) return -1;
            len = 1 + (tag >> 2);
            off = zstd::le32(ip);
            ip += 4;
        }
        if (off == 0 || off > op - dst || len > oend - op) return -1;
        copy_match(op, op - off, len);
        op += len;
    }
    if (op != oend) return -1;
    return op - dst;
}

// liblzf decompression (h5py's LZF filter) of src[0:n] into dst[0:cap];
// returns the bytes written, -1 (corrupt) or -2 (does not fit)
int64_t lzf_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t cap) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    uint8_t* op = dst;
    uint8_t* const oend = dst + cap;
    while (ip < iend) {
        const uint32_t ctrl = *ip++;
        if (ctrl < 32) {
            const int64_t len = ctrl + 1;
            if (len > iend - ip) return -1;
            if (len > oend - op) return -2;
            std::memcpy(op, ip, size_t(len));
            op += len;
            ip += len;
            continue;
        }
        int64_t len = ctrl >> 5;
        if (ip >= iend) return -1;
        if (len == 7) {
            len += *ip++;
            if (ip >= iend) return -1;
        }
        const int64_t back = (int64_t(ctrl & 0x1f) << 8) + *ip++ + 1;
        len += 2;
        if (back > op - dst) return -1;
        if (len > oend - op) return -2;
        copy_match(op, op - back, len);
        op += len;
    }
    return op - dst;
}

// c-blosc's bitunshuffle of one block src[0:n] of ``typesize``-byte
// elements into dst: within each group of 8 elements the stored order is
// bit k of byte j of every element, by j then k.  ``version`` is the
// frame's format version: before 3, a block whose element count is not a
// multiple of 8 was stored as it lay; from 3 on, the elements past the
// last full group of 8 (and any bytes past the last element) are stored
// as they lie
void bitunshuffle(const uint8_t* src, int64_t n, int64_t typesize,
                  int64_t version, uint8_t* dst) {
    int64_t size = n / typesize;
    if (version < 3 && size % 8) {
        std::memcpy(dst, src, size_t(n));
        return;
    }
    size -= size % 8;
    const int64_t groups = size / 8;
    for (int64_t j = 0; j < typesize; ++j) {
        const uint8_t* rows = src + j * 8 * groups;
        for (int64_t g = 0; g < groups; ++g) {
            uint64_t x = 0;
            for (int k = 0; k < 8; ++k)
                x |= uint64_t(rows[k * groups + g]) << (8 * k);
            x = transpose_bits(x);
            uint8_t* out = dst + (8 * g) * typesize + j;
            for (int t = 0; t < 8; ++t) out[t * typesize] = uint8_t(x >> (8 * t));
        }
    }
    const int64_t done = size * typesize;
    std::memcpy(dst + done, src + done, size_t(n - done));
}

// HDF5's metadata checksum: Jenkins' lookup3 ``hashlittle`` of p[0:n]
// (H5_checksum_lookup3 in H5checksum.c)
uint32_t lookup3(const uint8_t* k, int64_t n, uint32_t initval) {
    auto rot = [](uint32_t x, int r) { return (x << r) | (x >> (32 - r)); };
    uint32_t a, b, c;
    a = b = c = 0xdeadbeefu + uint32_t(n) + initval;
    while (n > 12) {
        a += k[0] + (uint32_t(k[1]) << 8) + (uint32_t(k[2]) << 16) + (uint32_t(k[3]) << 24);
        b += k[4] + (uint32_t(k[5]) << 8) + (uint32_t(k[6]) << 16) + (uint32_t(k[7]) << 24);
        c += k[8] + (uint32_t(k[9]) << 8) + (uint32_t(k[10]) << 16) + (uint32_t(k[11]) << 24);
        a -= c; a ^= rot(c, 4);  c += b;
        b -= a; b ^= rot(a, 6);  a += c;
        c -= b; c ^= rot(b, 8);  b += a;
        a -= c; a ^= rot(c, 16); c += b;
        b -= a; b ^= rot(a, 19); a += c;
        c -= b; c ^= rot(b, 4);  b += a;
        n -= 12;
        k += 12;
    }
    switch (n) {  // each case falls through to the next
        case 12: c += uint32_t(k[11]) << 24; [[fallthrough]];
        case 11: c += uint32_t(k[10]) << 16; [[fallthrough]];
        case 10: c += uint32_t(k[9]) << 8; [[fallthrough]];
        case 9: c += k[8]; [[fallthrough]];
        case 8: b += uint32_t(k[7]) << 24; [[fallthrough]];
        case 7: b += uint32_t(k[6]) << 16; [[fallthrough]];
        case 6: b += uint32_t(k[5]) << 8; [[fallthrough]];
        case 5: b += k[4]; [[fallthrough]];
        case 4: a += uint32_t(k[3]) << 24; [[fallthrough]];
        case 3: a += uint32_t(k[2]) << 16; [[fallthrough]];
        case 2: a += uint32_t(k[1]) << 8; [[fallthrough]];
        case 1: a += k[0]; break;
        case 0: return c;
    }
    c ^= b; c -= rot(b, 14);
    a ^= c; a -= rot(c, 11);
    b ^= a; b -= rot(a, 25);
    c ^= b; c -= rot(b, 16);
    a ^= c; a -= rot(c, 4);
    b ^= a; b -= rot(a, 14);
    c ^= b; c -= rot(b, 24);
    return c;
}

// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) of p[0:n],
// continuing from ``crc`` (0 to start): the checksum that closes every
// file of tensorstore's OCDBT format
uint32_t crc32c(const uint8_t* p, int64_t n, uint32_t crc) {
    static const auto table = [] {
        std::vector<uint32_t> t(256);
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
            t[i] = c;
        }
        return t;
    }();
    crc = ~crc;
    for (int64_t i = 0; i < n; ++i) crc = table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
    return ~crc;
}

}  // extern "C"
