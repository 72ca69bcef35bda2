// sdr_tpu_torch's native block loader (a copy of the JAX package's
// native/sdr_loader.cpp; sdr_tpu_torch/io/native.py builds and binds it).
//
// Samples are ingested on a dedicated OS thread: a producer (a file
// reader, optionally looping, or a UDP receiver) fills pre-allocated
// page-aligned block buffers in a bounded ring; the Python side pops a
// filled block, copies it out as an array (a tensor's host side) and
// releases the slot.  Bounded ring => backpressure (file) or
// drop-with-count (UDP: a live source cannot be held back).
//
// Plain C ABI for ctypes.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

struct Ring {
    std::vector<uint8_t*> slots;
    std::vector<size_t> fill;        // bytes valid in each slot
    size_t block_bytes = 0;
    int n = 0;
    // ring indices: produced (writer), consumed (reader)
    std::mutex mu;
    std::condition_variable cv_can_produce, cv_can_consume;
    int64_t produced = 0, consumed = 0, released = 0;
    std::atomic<int64_t> dropped{0};
    std::atomic<bool> done{false}, stop{false};
    std::thread worker;

    ~Ring() {
        stop.store(true);
        cv_can_produce.notify_all();
        cv_can_consume.notify_all();
        if (worker.joinable()) worker.join();
        for (auto* p : slots) std::free(p);
    }

    bool init(size_t bb, int nbuf) {
        block_bytes = bb;
        n = nbuf;
        slots.resize(n);
        fill.assign(n, 0);
        for (int i = 0; i < n; i++) {
            void* p = nullptr;
            if (posix_memalign(&p, 4096, bb) != 0) return false;
            slots[i] = static_cast<uint8_t*>(p);
        }
        return true;
    }

    // writer side: returns slot pointer to fill, or null on stop.
    uint8_t* acquire_produce() {
        std::unique_lock<std::mutex> lk(mu);
        cv_can_produce.wait(lk, [&] {
            return stop.load() || produced - released < n;
        });
        if (stop.load()) return nullptr;
        return slots[produced % n];
    }

    void commit_produce(size_t bytes) {
        {
            std::lock_guard<std::mutex> lk(mu);
            fill[produced % n] = bytes;
            produced++;
        }
        cv_can_consume.notify_one();
    }

    // reader side: blocking pop; returns slot index or -1 when finished.
    int pop(uint8_t** out, size_t* bytes, double timeout_s) {
        std::unique_lock<std::mutex> lk(mu);
        auto pred = [&] {
            return stop.load() || consumed < produced ||
                   (done.load() && consumed == produced);
        };
        if (timeout_s < 0) {
            cv_can_consume.wait(lk, pred);
        } else if (!cv_can_consume.wait_for(
                       lk, std::chrono::duration<double>(timeout_s), pred)) {
            return -2;  // timeout
        }
        if (stop.load()) return -1;
        if (consumed == produced && done.load()) return -1;
        int slot = static_cast<int>(consumed % n);
        *out = slots[slot];
        *bytes = fill[slot];
        consumed++;
        return slot;
    }

    void release() {
        {
            std::lock_guard<std::mutex> lk(mu);
            released++;
        }
        cv_can_produce.notify_one();
    }
};

void file_producer(Ring* r, std::string path, int repeat) {
    FILE* fh = std::fopen(path.c_str(), "rb");
    if (!fh) { r->done.store(true); r->cv_can_consume.notify_all(); return; }
    while (!r->stop.load()) {
        uint8_t* slot = r->acquire_produce();
        if (!slot) break;
        size_t got = std::fread(slot, 1, r->block_bytes, fh);
        if (got < r->block_bytes) {
            if (repeat) {   // wrap: refill the remainder from the start
                std::rewind(fh);
                size_t more = std::fread(slot + got, 1,
                                         r->block_bytes - got, fh);
                got += more;
                if (got < r->block_bytes) break;  // file smaller than block
            } else {
                break;      // drop trailing partial block
            }
        }
        r->commit_produce(got);
    }
    std::fclose(fh);
    r->done.store(true);
    r->cv_can_consume.notify_all();
}

void udp_producer(Ring* r, int port) {
    int s = socket(AF_INET, SOCK_DGRAM, 0);
    if (s < 0) { r->done.store(true); r->cv_can_consume.notify_all(); return; }
    int rcv = 1 << 22;
    setsockopt(s, SOL_SOCKET, SO_RCVBUF, &rcv, sizeof(rcv));
    struct timeval tv {0, 200000};  // poll stop flag 5x/sec
    setsockopt(s, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (bind(s, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
        close(s); r->done.store(true); r->cv_can_consume.notify_all(); return;
    }
    std::vector<uint8_t> scratch(r->block_bytes);
    while (!r->stop.load()) {
        ssize_t got = recv(s, scratch.data(), r->block_bytes, 0);
        if (got < 0) continue;                       // timeout -> poll stop
        if (static_cast<size_t>(got) < r->block_bytes) continue;  // partial
        // non-blocking acquire: drop (and count) if the ring is full — a
        // live radio cannot exert backpressure (RTLSDRStream uses an
        // unbounded mailbox; we bound memory and count overruns instead).
        {
            std::unique_lock<std::mutex> lk(r->mu);
            if (r->produced - r->released >= r->n) {
                r->dropped.fetch_add(1);
                continue;
            }
        }
        uint8_t* slot = r->acquire_produce();
        if (!slot) break;
        std::memcpy(slot, scratch.data(), r->block_bytes);
        r->commit_produce(r->block_bytes);
    }
    close(s);
    r->done.store(true);
    r->cv_can_consume.notify_all();
}

}  // namespace

extern "C" {

void* loader_open_file(const char* path, uint64_t block_bytes, int n_buffers,
                       int repeat) {
    auto* r = new Ring();
    if (!r->init(block_bytes, n_buffers)) { delete r; return nullptr; }
    r->worker = std::thread(file_producer, r, std::string(path), repeat);
    return r;
}

void* loader_open_udp(int port, uint64_t block_bytes, int n_buffers) {
    auto* r = new Ring();
    if (!r->init(block_bytes, n_buffers)) { delete r; return nullptr; }
    r->worker = std::thread(udp_producer, r, port);
    return r;
}

// Blocks until a filled slot is available.  Returns slot index >= 0 and
// sets *ptr; -1 on end-of-stream; -2 on timeout.
int loader_pop(void* h, uint8_t** ptr, uint64_t* bytes, double timeout_s) {
    size_t b = 0;
    int slot = static_cast<Ring*>(h)->pop(ptr, &b, timeout_s);
    *bytes = b;
    return slot;
}

// Release the oldest popped slot back to the producer.
void loader_release(void* h) { static_cast<Ring*>(h)->release(); }

int64_t loader_dropped(void* h) {
    return static_cast<Ring*>(h)->dropped.load();
}

void loader_close(void* h) { delete static_cast<Ring*>(h); }

}  // extern "C"
