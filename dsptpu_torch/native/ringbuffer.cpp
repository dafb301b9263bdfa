// Double-buffered streaming sample reader (native data-loader).
//
// The reference library is pure in-process Julia and has no IO layer;
// production streaming (BASELINE.json's 64-channel 100 MS/s synthetic
// stream) needs a loader that overlaps disk/pipe reads with device
// compute. This is a small C++ ring buffer: a reader thread fills N
// chunk slots ahead of the consumer; the consumer borrows a slot,
// hands the samples to the device pipeline, and releases it.
//
// Exposed as a C ABI consumed via ctypes (dsptpu_torch/native/__init__.py),
// which copies each borrowed chunk into a pinned host buffer for the card.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Ring {
    FILE* f = nullptr;
    size_t chunk_bytes = 0;
    int nslots = 0;
    std::vector<std::vector<char>> slots;
    std::vector<size_t> filled;     // bytes valid in each slot
    int head = 0;                   // next slot the reader fills
    int tail = 0;                   // next slot the consumer takes
    std::atomic<int> count{0};      // filled, unconsumed slots
    bool eof = false;
    bool closed = false;
    std::mutex mu;
    std::condition_variable cv_reader;
    std::condition_variable cv_consumer;
    std::thread reader;
};

void reader_loop(Ring* r) {
    for (;;) {
        std::unique_lock<std::mutex> lk(r->mu);
        r->cv_reader.wait(lk, [r] {
            return r->closed || r->count.load() < r->nslots;
        });
        if (r->closed) return;
        int slot = r->head;
        lk.unlock();

        size_t got = fread(r->slots[slot].data(), 1, r->chunk_bytes, r->f);

        lk.lock();
        r->filled[slot] = got;
        r->head = (r->head + 1) % r->nslots;
        r->count.fetch_add(1);
        if (got < r->chunk_bytes) r->eof = true;
        r->cv_consumer.notify_one();
        if (r->eof) return;
    }
}

}  // namespace

extern "C" {

// Open `path` for streaming with `nslots` prefetch chunks of
// `chunk_bytes` each. Returns an opaque handle or null.
void* rb_open(const char* path, size_t chunk_bytes, int nslots) {
    if (chunk_bytes == 0 || nslots < 2) return nullptr;
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    Ring* r = new Ring();
    r->f = f;
    r->chunk_bytes = chunk_bytes;
    r->nslots = nslots;
    r->slots.resize(nslots);
    r->filled.assign(nslots, 0);
    for (auto& s : r->slots) s.resize(chunk_bytes);
    r->reader = std::thread(reader_loop, r);
    return r;
}

// Borrow the next filled chunk. Blocks until data is ready. Returns
// the number of valid bytes (0 at end of stream) and stores the
// buffer pointer in *out. The buffer stays valid until rb_release.
size_t rb_next(void* h, const char** out) {
    Ring* r = static_cast<Ring*>(h);
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv_consumer.wait(lk, [r] {
        return r->closed || r->count.load() > 0 ||
               (r->eof && r->count.load() == 0);
    });
    if (r->closed || r->count.load() == 0) {  // closed or drained
        *out = nullptr;
        return 0;
    }
    int slot = r->tail;
    *out = r->slots[slot].data();
    return r->filled[slot];
}

// Release the chunk obtained from rb_next so the reader can reuse it.
void rb_release(void* h) {
    Ring* r = static_cast<Ring*>(h);
    std::lock_guard<std::mutex> lk(r->mu);
    r->tail = (r->tail + 1) % r->nslots;
    r->count.fetch_sub(1);
    r->cv_reader.notify_one();
}

void rb_close(void* h) {
    Ring* r = static_cast<Ring*>(h);
    {
        std::lock_guard<std::mutex> lk(r->mu);
        r->closed = true;
        r->cv_reader.notify_all();
        r->cv_consumer.notify_all();
    }
    if (r->reader.joinable()) r->reader.join();
    fclose(r->f);
    delete r;
}

}  // extern "C"
