// Native block reader: thread-pool pread into caller-owned buffers.
//
// The Python loader computes byte offsets from the contiguous-HDF5 layout
// once, and this reader streams the blocks with POSIX pread on a small
// thread pool, outside the GIL (the ctypes call releases it). Used by
// makani_torch/utils/dataloaders/data_loader_multifiles.py under
// MAKANI_NATIVE_READER=1; a failure there raises (no fallback).
//
// Build: g++ -O3 -shared -fPIC -pthread reader.cpp -o libreader.so

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

// Reads n blocks from `path`: block i is `sizes[i]` bytes at file offset
// `offsets[i]`, written to dest + dest_offsets[i]. Returns 0 on success,
// else the first errno observed (EIO for a file shorter than a block).
// nthreads <= 0 means hardware concurrency.
int mk_read_blocks(const char* path, const uint64_t* offsets, const uint64_t* sizes,
                   char* dest, const uint64_t* dest_offsets, int64_t n, int nthreads) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return errno;
#ifdef POSIX_FADV_SEQUENTIAL
    posix_fadvise(fd, 0, 0, POSIX_FADV_SEQUENTIAL);
#endif
    if (nthreads <= 0) {
        unsigned hc = std::thread::hardware_concurrency();
        nthreads = hc ? (int)hc : 1;
    }
    if ((int64_t)nthreads > n) nthreads = (int)n;

    std::atomic<int64_t> next(0);
    std::atomic<int> err(0);

    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n || err.load()) break;
            uint64_t remaining = sizes[i];
            uint64_t foff = offsets[i];
            char* d = dest + dest_offsets[i];
            while (remaining > 0) {
                ssize_t got = pread(fd, d, remaining, (off_t)foff);
                if (got < 0) {
                    if (errno == EINTR) continue;
                    err.store(errno ? errno : EIO);
                    break;
                }
                if (got == 0) {  // short file
                    err.store(EIO);
                    break;
                }
                remaining -= (uint64_t)got;
                foff += (uint64_t)got;
                d += got;
            }
        }
    };

    if (nthreads <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        pool.reserve(nthreads);
        for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
    close(fd);
    return err.load();
}

}  // extern "C"
