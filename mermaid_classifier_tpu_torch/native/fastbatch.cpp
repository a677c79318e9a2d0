// fastbatch: memory-mapped packed-feature-cache reader with a
// multi-threaded row gather, for the port's streamed head-training epochs.
//
// The port's own copy of mermaid_classifier_tpu/native/fastbatch.cpp. The
// packed cache is one flat float32 row-major matrix on disk; a shuffled
// mini-batch is a gather of rows into a caller-provided buffer. Threaded
// memcpy from the page cache moves rows faster than a single-threaded
// numpy fancy-index, and the mapping keeps resident memory O(batch), not
// O(dataset). This is host code, not a CUDA kernel.
//
// Build: g++ -O3 -shared -fPIC -pthread -o libfastbatch.so fastbatch.cpp
// (driven by mermaid_classifier_tpu_torch/native/fastbatch.py ensure_built()).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Cache {
    int fd = -1;
    const float* data = nullptr;
    std::int64_t rows = 0;
    std::int64_t dim = 0;
    std::size_t bytes = 0;
};

}  // namespace

extern "C" {

// Open a packed cache: flat float32 row-major (rows x dim). Returns nullptr
// on any failure (missing file, size mismatch).
void* fc_open(const char* path, std::int64_t rows, std::int64_t dim) {
    if (rows < 0 || dim <= 0) return nullptr;
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) {
        ::close(fd);
        return nullptr;
    }
    const std::size_t expected =
        static_cast<std::size_t>(rows) * static_cast<std::size_t>(dim) * sizeof(float);
    if (static_cast<std::size_t>(st.st_size) < expected) {
        ::close(fd);
        return nullptr;
    }
    void* mapped = nullptr;
    if (expected > 0) {
        mapped = mmap(nullptr, expected, PROT_READ, MAP_SHARED, fd, 0);
        if (mapped == MAP_FAILED) {
            ::close(fd);
            return nullptr;
        }
        // Rows are read in shuffled order; demand paging with readahead off
        // the table would thrash, so advise random access.
        madvise(mapped, expected, MADV_RANDOM);
    }
    Cache* cache = new Cache();
    cache->fd = fd;
    cache->data = static_cast<const float*>(mapped);
    cache->rows = rows;
    cache->dim = dim;
    cache->bytes = expected;
    return cache;
}

void fc_close(void* handle) {
    if (handle == nullptr) return;
    Cache* cache = static_cast<Cache*>(handle);
    if (cache->data != nullptr && cache->bytes > 0) {
        munmap(const_cast<float*>(cache->data), cache->bytes);
    }
    if (cache->fd >= 0) ::close(cache->fd);
    delete cache;
}

std::int64_t fc_rows(void* handle) {
    return handle ? static_cast<Cache*>(handle)->rows : -1;
}

std::int64_t fc_dim(void* handle) {
    return handle ? static_cast<Cache*>(handle)->dim : -1;
}

// Gather rows data[idx[i], :] -> out[i, :] with n_threads workers.
// Returns 0 on success, -1 on a bad handle, or (1 + i) for the first
// out-of-range index i (validated up front, before any copy).
int fc_gather(void* handle, const std::int64_t* idx, std::int64_t n,
              float* out, int n_threads) {
    if (handle == nullptr || idx == nullptr || out == nullptr || n < 0) return -1;
    Cache* cache = static_cast<Cache*>(handle);
    for (std::int64_t i = 0; i < n; ++i) {
        if (idx[i] < 0 || idx[i] >= cache->rows) {
            return static_cast<int>(1 + i);
        }
    }
    const std::int64_t dim = cache->dim;
    const float* data = cache->data;
    const std::size_t row_bytes = static_cast<std::size_t>(dim) * sizeof(float);

    if (n_threads < 1) n_threads = 1;
    const unsigned hw = std::thread::hardware_concurrency();
    if (hw > 0 && n_threads > static_cast<int>(hw)) n_threads = static_cast<int>(hw);
    if (n < n_threads * 4) n_threads = 1;  // tiny batches: threads cost more

    auto copy_range = [&](std::int64_t lo, std::int64_t hi) {
        for (std::int64_t i = lo; i < hi; ++i) {
            std::memcpy(out + i * dim, data + idx[i] * dim, row_bytes);
        }
    };
    if (n_threads == 1) {
        copy_range(0, n);
        return 0;
    }
    std::vector<std::thread> workers;
    workers.reserve(n_threads);
    const std::int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const std::int64_t lo = t * chunk;
        const std::int64_t hi = std::min<std::int64_t>(lo + chunk, n);
        if (lo >= hi) break;
        workers.emplace_back(copy_range, lo, hi);
    }
    for (auto& w : workers) w.join();
    return 0;
}

}  // extern "C"
