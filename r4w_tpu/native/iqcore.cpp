// iqcore — native host-side runtime for r4w_tpu.
//
// Fills the performance role of the reference's native Rust runtime
// pieces (SURVEY.md §2.8): interleaved IQ format conversion
// (io/format.rs hot loops), a lock-free SPSC ring buffer
// (rt/ringbuffer.rs), and UDP IQ packet framing (udp_source_sink.rs).
// The device compute path stays in XLA; this library keeps the
// host I/O path off the Python interpreter.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libiqcore.so iqcore.cpp
// ABI: plain C, consumed via ctypes (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>
#include <thread>

#if defined(__unix__) || defined(__APPLE__)
#define IQCORE_HAVE_SOCKETS 1
#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>
#endif

extern "C" {

// ---------------------------------------------------------------------
// IQ format conversion: interleaved f32 <-> i16/i8/u8 with scaling.
// The loops are written so the compiler auto-vectorizes them.
// ---------------------------------------------------------------------

void iq_f32_to_i16(const float* in, int16_t* out, int64_t n, float scale) {
    for (int64_t i = 0; i < n; ++i) {
        float v = in[i] * scale;
        if (v > 32767.f) v = 32767.f;
        if (v < -32768.f) v = -32768.f;
        out[i] = (int16_t)(v >= 0 ? v + 0.5f : v - 0.5f);
    }
}

void iq_i16_to_f32(const int16_t* in, float* out, int64_t n, float inv_scale) {
    for (int64_t i = 0; i < n; ++i) out[i] = in[i] * inv_scale;
}

void iq_f32_to_i8(const float* in, int8_t* out, int64_t n, float scale) {
    for (int64_t i = 0; i < n; ++i) {
        float v = in[i] * scale;
        if (v > 127.f) v = 127.f;
        if (v < -128.f) v = -128.f;
        out[i] = (int8_t)(v >= 0 ? v + 0.5f : v - 0.5f);
    }
}

void iq_i8_to_f32(const int8_t* in, float* out, int64_t n, float inv_scale) {
    for (int64_t i = 0; i < n; ++i) out[i] = in[i] * inv_scale;
}

void iq_f32_to_u8(const float* in, uint8_t* out, int64_t n,
                  float scale, float offset) {
    for (int64_t i = 0; i < n; ++i) {
        float v = in[i] * scale + offset;
        if (v > 255.f) v = 255.f;
        if (v < 0.f) v = 0.f;
        out[i] = (uint8_t)(v + 0.5f);
    }
}

void iq_u8_to_f32(const uint8_t* in, float* out, int64_t n,
                  float inv_scale, float offset) {
    for (int64_t i = 0; i < n; ++i) out[i] = (in[i] - offset) * inv_scale;
}

// split complex (re[i], im[i]) <-> interleaved (re0, im0, re1, im1, ...)
void iq_interleave(const float* re, const float* im, float* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        out[2 * i] = re[i];
        out[2 * i + 1] = im[i];
    }
}

void iq_deinterleave(const float* in, float* re, float* im, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        re[i] = in[2 * i];
        im[i] = in[2 * i + 1];
    }
}

// ---------------------------------------------------------------------
// Lock-free SPSC ring buffer over float pairs (rt/ringbuffer.rs role).
// Capacity is rounded up to a power of two; one slot reserved.
// ---------------------------------------------------------------------

struct RingBuffer {
    float* data;
    uint64_t capacity;   // in floats, power of two
    uint64_t mask;
    std::atomic<uint64_t> head;  // write index
    std::atomic<uint64_t> tail;  // read index
};

void* ring_create(uint64_t capacity_floats) {
    uint64_t cap = 1;
    while (cap < capacity_floats + 1) cap <<= 1;
    RingBuffer* rb = new (std::nothrow) RingBuffer;
    if (!rb) return nullptr;
    rb->data = new (std::nothrow) float[cap];
    if (!rb->data) { delete rb; return nullptr; }
    rb->capacity = cap;
    rb->mask = cap - 1;
    rb->head.store(0, std::memory_order_relaxed);
    rb->tail.store(0, std::memory_order_relaxed);
    return rb;
}

void ring_destroy(void* p) {
    RingBuffer* rb = (RingBuffer*)p;
    if (!rb) return;
    delete[] rb->data;
    delete rb;
}

uint64_t ring_available_read(void* p) {
    RingBuffer* rb = (RingBuffer*)p;
    return rb->head.load(std::memory_order_acquire)
         - rb->tail.load(std::memory_order_acquire);
}

uint64_t ring_available_write(void* p) {
    RingBuffer* rb = (RingBuffer*)p;
    return rb->capacity - 1 - ring_available_read(p);
}

// returns floats actually written (producer side)
uint64_t ring_write(void* p, const float* src, uint64_t n) {
    RingBuffer* rb = (RingBuffer*)p;
    uint64_t can = ring_available_write(p);
    if (n > can) n = can;
    uint64_t head = rb->head.load(std::memory_order_relaxed);
    for (uint64_t i = 0; i < n; ++i)
        rb->data[(head + i) & rb->mask] = src[i];
    rb->head.store(head + n, std::memory_order_release);
    return n;
}

// returns floats actually read (consumer side)
uint64_t ring_read(void* p, float* dst, uint64_t n) {
    RingBuffer* rb = (RingBuffer*)p;
    uint64_t can = ring_available_read(p);
    if (n > can) n = can;
    uint64_t tail = rb->tail.load(std::memory_order_relaxed);
    for (uint64_t i = 0; i < n; ++i)
        dst[i] = rb->data[(tail + i) & rb->mask];
    rb->tail.store(tail + n, std::memory_order_release);
    return n;
}

// ---------------------------------------------------------------------
// UDP IQ packet framing (udp_source_sink.rs wire format):
// [seq u32 LE][interleaved f32 LE...]
// ---------------------------------------------------------------------

int64_t udp_frame_packet(uint32_t seq, const float* samples,
                         int64_t n_floats, uint8_t* out,
                         int64_t out_capacity) {
    int64_t need = 4 + n_floats * 4;
    if (out_capacity < need) return -1;
    std::memcpy(out, &seq, 4);
    std::memcpy(out + 4, samples, (size_t)n_floats * 4);
    return need;
}

int64_t udp_parse_packet(const uint8_t* in, int64_t n_bytes,
                         uint32_t* seq, float* samples,
                         int64_t samples_capacity) {
    if (n_bytes < 4) return -1;
    std::memcpy(seq, in, 4);
    int64_t nf = (n_bytes - 4) / 4;
    if (nf > samples_capacity) return -1;
    std::memcpy(samples, in + 4, (size_t)nf * 4);
    return nf;
}

// ---------------------------------------------------------------------
// Native UDP IQ receiver (benchmark/receiver.rs:79 role): a dedicated
// thread drains the socket into the SPSC ring; Python reads decoded
// f32 samples in bulk — no per-packet interpreter work on the hot
// path. Tracks packets, sequence gaps, and ring overruns.
// ---------------------------------------------------------------------

#ifdef IQCORE_HAVE_SOCKETS

struct UdpRx {
    int fd;
    RingBuffer* ring;
    std::thread thread;
    std::atomic<bool> stop;
    std::atomic<uint64_t> packets;
    std::atomic<uint64_t> seq_gaps;
    std::atomic<uint64_t> overrun_floats;
    uint32_t last_seq;
    bool have_seq;
    bool has_header;
    int port;
};

static void udprx_loop(UdpRx* rx) {
    // one MTU-ish buffer; payloads beyond 65507 are impossible for UDP
    static thread_local uint8_t buf[65536];
    while (!rx->stop.load(std::memory_order_relaxed)) {
        ssize_t n = recv(rx->fd, buf, sizeof(buf), 0);
        if (n <= 0) continue;  // timeout or error: re-check stop
        const uint8_t* body = buf;
        int64_t nb = n;
        if (rx->has_header) {
            if (nb < 4) continue;
            uint32_t seq;
            std::memcpy(&seq, buf, 4);
            if (rx->have_seq && seq != rx->last_seq + 1)
                rx->seq_gaps.fetch_add(1, std::memory_order_relaxed);
            rx->last_seq = seq;
            rx->have_seq = true;
            body += 4;
            nb -= 4;
        }
        uint64_t nf = (uint64_t)(nb / 4);
        uint64_t wrote = ring_write(rx->ring, (const float*)body, nf);
        if (wrote < nf)
            rx->overrun_floats.fetch_add(nf - wrote,
                                         std::memory_order_relaxed);
        rx->packets.fetch_add(1, std::memory_order_relaxed);
    }
}

// returns handle or nullptr; port 0 binds an ephemeral port.
// bind_any=0 -> 127.0.0.1 (default, no network exposure); 1 -> 0.0.0.0
void* udprx_create(int port, uint64_t ring_capacity_floats,
                   int has_header, int bind_any) {
    int fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (fd < 0) return nullptr;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    int rcvbuf = 4 * 1024 * 1024;
    setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
    struct timeval tv {0, 100000};  // 100 ms poll for clean shutdown
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(bind_any ? INADDR_ANY
                                          : INADDR_LOOPBACK);
    addr.sin_port = htons((uint16_t)port);
    if (bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
        close(fd);
        return nullptr;
    }
    socklen_t len = sizeof(addr);
    getsockname(fd, (sockaddr*)&addr, &len);

    UdpRx* rx = new (std::nothrow) UdpRx;
    if (!rx) { close(fd); return nullptr; }
    rx->fd = fd;
    rx->ring = (RingBuffer*)ring_create(ring_capacity_floats);
    if (!rx->ring) { close(fd); delete rx; return nullptr; }
    rx->stop.store(false);
    rx->packets.store(0);
    rx->seq_gaps.store(0);
    rx->overrun_floats.store(0);
    rx->have_seq = false;
    rx->last_seq = 0;
    rx->has_header = has_header != 0;
    rx->port = (int)ntohs(addr.sin_port);
    rx->thread = std::thread(udprx_loop, rx);
    return rx;
}

int udprx_port(void* p) { return ((UdpRx*)p)->port; }

// bulk read of decoded interleaved f32 samples; returns floats read
uint64_t udprx_read(void* p, float* dst, uint64_t max_floats) {
    return ring_read(((UdpRx*)p)->ring, dst, max_floats);
}

uint64_t udprx_available(void* p) {
    return ring_available_read(((UdpRx*)p)->ring);
}

uint64_t udprx_packets(void* p) {
    return ((UdpRx*)p)->packets.load(std::memory_order_relaxed);
}

uint64_t udprx_seq_gaps(void* p) {
    return ((UdpRx*)p)->seq_gaps.load(std::memory_order_relaxed);
}

uint64_t udprx_overruns(void* p) {
    return ((UdpRx*)p)->overrun_floats.load(std::memory_order_relaxed);
}

void udprx_destroy(void* p) {
    UdpRx* rx = (UdpRx*)p;
    if (!rx) return;
    rx->stop.store(true);
    if (rx->thread.joinable()) rx->thread.join();
    close(rx->fd);
    ring_destroy(rx->ring);
    delete rx;
}

#endif  // IQCORE_HAVE_SOCKETS

int iqcore_abi_version() { return 2; }

}  // extern "C"
