// The host's safetensors data plane: mmap, header scan and page-cache advice.
//
// The port's own copy of the JAX package's native mmap (the reference's
// basic_memfile mmap and declare_mapped residency, include/metalchat/
// container.h): the file is mapped read-only, the 8-byte header length is
// read and checked, and the mapping is exposed as a raw pointer that the
// Python layer wraps, without a copy, into numpy views. madvise(WILLNEED)
// asks the kernel to page a multi-GB checkpoint in ahead of the reads that
// stack its tensors for the upload to the card.
//
// One change from the JAX package's copy: the file descriptor is closed as
// soon as the mapping exists (the mapping does not need it), so a process
// that keeps many documents open holds no descriptor for each.
//
// C interface only, loaded with ctypes.

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

struct MappedFile {
  void* data;
  uint64_t size;
};

// Open and map a file read-only. Returns nullptr on failure, with errno set
// (EINVAL for an empty file, which cannot be mapped).
MappedFile* mc_mmap_open(const char* path) {
  int fd = ::open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  if (st.st_size <= 0) {
    ::close(fd);
    errno = EINVAL;
    return nullptr;
  }
  void* data = ::mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                      MAP_PRIVATE, fd, 0);
  int saved = errno;
  ::close(fd);
  if (data == MAP_FAILED) {
    errno = saved;
    return nullptr;
  }
  return new MappedFile{data, static_cast<uint64_t>(st.st_size)};
}

const uint8_t* mc_mmap_data(const MappedFile* mf) {
  return static_cast<const uint8_t*>(mf->data);
}

uint64_t mc_mmap_size(const MappedFile* mf) { return mf->size; }

// The 8-byte little-endian header length; 0 for an implausible header (the
// Python parser's checks: at most 100 MiB, and inside the file).
uint64_t mc_header_len(const MappedFile* mf) {
  if (mf->size < 8) return 0;
  uint64_t n;
  std::memcpy(&n, mf->data, 8);
  if (n > (100ull << 20) || 8 + n > mf->size) return 0;
  return n;
}

// advice: 0 = normal, 1 = willneed (prefetch), 2 = sequential, 3 = dontneed.
// Returns madvise's result (0, or -1 with errno set); -1 for an unknown code.
int mc_mmap_advise(MappedFile* mf, uint64_t offset, uint64_t length, int advice) {
  static const int kAdvice[] = {MADV_NORMAL, MADV_WILLNEED, MADV_SEQUENTIAL,
                                MADV_DONTNEED};
  if (advice < 0 || advice > 3) return -1;
  long page = ::sysconf(_SC_PAGESIZE);
  uint64_t aligned = offset & ~static_cast<uint64_t>(page - 1);
  uint64_t delta = offset - aligned;
  return ::madvise(static_cast<uint8_t*>(mf->data) + aligned, length + delta,
                   kAdvice[advice]);
}

// Unmap. Every pointer into the mapping is invalid afterwards.
void mc_mmap_close(MappedFile* mf) {
  if (!mf) return;
  ::munmap(mf->data, mf->size);
  delete mf;
}

}  // extern "C"
