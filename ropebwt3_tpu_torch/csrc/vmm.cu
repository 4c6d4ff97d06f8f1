// One virtual address range over physical allocations on one or more cards
// (CUDA's virtual memory management), as a plain C interface for
// parallel/mesh.py `ShardedRows`: the idx slabs of an index's occ rows, each
// a physical allocation on the card that owns it, mapped side by side, so a
// kernel reads global row bi at base + row_bytes * bi through one pointer,
// as it reads an unsharded table, with no shard lookup in its chain.
//
// With it the kernels need no shard table (a chain of selects over the
// shards' first rows in every rank) to stand in for the JAX package's
// masked partial rank and its psum over `idx` (ropebwt3_tpu/parallel/
// mesh.py rank1a_local).  libcuda's cuMem* calls are looked up through
// cudaGetDriverEntryPoint(ByVersion): no link-time dependency on libcuda.
//
// Across the processes of one node (a dp row whose slots two processes
// hold), the process that owns a slab creates it shareable, exports it as
// a POSIX file descriptor (rb3c_vmm_export), and every other process of
// the row imports the descriptor (rb3c_vmm_import) and maps the handle it
// gets into its own copy of the row's range, at the slab's offset; each
// process then grants its own cards access to its whole range.  The
// descriptors travel between the processes over a Unix socket
// (parallel/ipc.py).
//
// Every entry point returns 0 or an error code: a CUresult, or kRuntime +
// a cudaError_t where a runtime call failed (rb3c_vmm_error names either).
// Sizes and offsets are bytes, multiples of the granularity; pointers and
// handles travel as uint64.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRuntime = 100000;

struct CuApi {
  decltype(&cuMemGetAllocationGranularity) granularity = nullptr;
  decltype(&cuMemAddressReserve) reserve = nullptr;
  decltype(&cuMemAddressFree) address_free = nullptr;
  decltype(&cuMemCreate) create = nullptr;
  decltype(&cuMemRelease) release = nullptr;
  decltype(&cuMemMap) map = nullptr;
  decltype(&cuMemUnmap) unmap = nullptr;
  decltype(&cuMemSetAccess) set_access = nullptr;
  decltype(&cuGetErrorString) error_string = nullptr;
  decltype(&cuMemExportToShareableHandle) export_handle = nullptr;
  decltype(&cuMemImportFromShareableHandle) import_handle = nullptr;
  decltype(&cuDeviceGet) device_get = nullptr;
  decltype(&cuDeviceGetAttribute) attribute = nullptr;
  int status = -1;  // -1: not loaded yet; then 0 or the error of the first lookup that failed
};

template <typename F>
int entry(const char* name, F* fn) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t e = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  if (e != cudaSuccess) return kRuntime + (int)e;
  if (q != cudaDriverEntryPointSuccess || p == nullptr) return kRuntime + (int)cudaErrorSymbolNotFound;
  *fn = reinterpret_cast<F>(p);
  return 0;
}

// libcuda's functions, looked up once; the current device's primary
// context made current (the runtime's), which the cuMem* calls need.
int cu_api(CuApi** out) {
  static CuApi d;
  if (d.status < 0) {
    int s = entry("cuMemGetAllocationGranularity", &d.granularity);
    if (!s) s = entry("cuMemAddressReserve", &d.reserve);
    if (!s) s = entry("cuMemAddressFree", &d.address_free);
    if (!s) s = entry("cuMemCreate", &d.create);
    if (!s) s = entry("cuMemRelease", &d.release);
    if (!s) s = entry("cuMemMap", &d.map);
    if (!s) s = entry("cuMemUnmap", &d.unmap);
    if (!s) s = entry("cuMemSetAccess", &d.set_access);
    if (!s) s = entry("cuGetErrorString", &d.error_string);
    if (!s) s = entry("cuMemExportToShareableHandle", &d.export_handle);
    if (!s) s = entry("cuMemImportFromShareableHandle", &d.import_handle);
    if (!s) s = entry("cuDeviceGet", &d.device_get);
    if (!s) s = entry("cuDeviceGetAttribute", &d.attribute);
    d.status = s;
  }
  if (d.status) return d.status;
  const cudaError_t e = cudaFree(nullptr);
  if (e != cudaSuccess) return kRuntime + (int)e;
  *out = &d;
  return 0;
}

// An allocation on card dev; `shareable` ones can be exported as a POSIX
// file descriptor (a handle type the allocation must be created with).
CUmemAllocationProp device_prop(int dev, int shareable) {
  CUmemAllocationProp p = {};
  p.type = CU_MEM_ALLOCATION_TYPE_PINNED;
  p.location.type = CU_MEM_LOCATION_TYPE_DEVICE;
  p.location.id = dev;
  if (shareable) p.requestedHandleTypes = CU_MEM_HANDLE_TYPE_POSIX_FILE_DESCRIPTOR;
  return p;
}

}  // namespace

extern "C" {

// The minimum granularity of a physical allocation on card dev (and so of
// every mapped size and offset), in bytes, for a shareable allocation or not.
int rb3c_vmm_granularity(int dev, int shareable, unsigned long long* out) {
  CuApi* d;
  int s = cu_api(&d);
  if (s) return s;
  const CUmemAllocationProp p = device_prop(dev, shareable);
  size_t g = 0;
  s = (int)d->granularity(&g, &p, CU_MEM_ALLOC_GRANULARITY_MINIMUM);
  *out = g;
  return s;
}

// *can = 1 when card a can read memory that lies on card b.
int rb3c_vmm_can_access(int a, int b, int* can) {
  const cudaError_t e = cudaDeviceCanAccessPeer(can, a, b);
  return e == cudaSuccess ? 0 : kRuntime + (int)e;
}

// Reserve a virtual range of `size` bytes aligned to `align`.
int rb3c_vmm_reserve(unsigned long long size, unsigned long long align, unsigned long long* ptr) {
  CuApi* d;
  int s = cu_api(&d);
  if (s) return s;
  CUdeviceptr p = 0;
  s = (int)d->reserve(&p, size, align, 0, 0);
  *ptr = p;
  return s;
}

// *ok = 1 when card dev can export and import allocations as POSIX file
// descriptors.
int rb3c_vmm_handle_fd_ok(int dev, int* ok) {
  CuApi* d;
  int s = cu_api(&d);
  if (s) return s;
  CUdevice cu;
  s = (int)d->device_get(&cu, dev);
  return s ? s : (int)d->attribute(ok, CU_DEVICE_ATTRIBUTE_HANDLE_TYPE_POSIX_FILE_DESCRIPTOR_SUPPORTED, cu);
}

// A physical allocation of `size` bytes on card dev, exportable when
// `shareable`; *handle names it.
int rb3c_vmm_create(int dev, unsigned long long size, int shareable, unsigned long long* handle) {
  CuApi* d;
  int s = cu_api(&d);
  if (s) return s;
  const CUmemAllocationProp p = device_prop(dev, shareable);
  CUmemGenericAllocationHandle h = 0;
  s = (int)d->create(&h, size, &p, 0);
  *handle = h;
  return s;
}

// A new POSIX file descriptor *fd for the shareable allocation `handle`,
// for another process to import; the caller closes it once it is sent.
int rb3c_vmm_export(unsigned long long handle, int* fd) {
  CuApi* d;
  const int s = cu_api(&d);
  return s ? s : (int)d->export_handle(fd, handle, CU_MEM_HANDLE_TYPE_POSIX_FILE_DESCRIPTOR, 0);
}

// The handle of the allocation that another process exported as fd; the
// caller closes fd (the handle keeps the allocation) and releases the
// handle (rb3c_vmm_release) once nothing maps it.
int rb3c_vmm_import(int fd, unsigned long long* handle) {
  CuApi* d;
  int s = cu_api(&d);
  if (s) return s;
  CUmemGenericAllocationHandle h = 0;
  s = (int)d->import_handle(&h, (void*)(uintptr_t)fd, CU_MEM_HANDLE_TYPE_POSIX_FILE_DESCRIPTOR);
  *handle = h;
  return s;
}

// Map `size` bytes of the physical allocation `handle` at ptr.
int rb3c_vmm_map(unsigned long long ptr, unsigned long long size, unsigned long long handle) {
  CuApi* d;
  const int s = cu_api(&d);
  return s ? s : (int)d->map(ptr, size, 0, handle, 0);
}

// Drop the handle: the memory lives on until its last mapping is unmapped.
int rb3c_vmm_release(unsigned long long handle) {
  CuApi* d;
  const int s = cu_api(&d);
  return s ? s : (int)d->release(handle);
}

// Let each of cards devs[0:n) read and write [ptr, ptr + size), which must
// be mapped throughout (the upload writes the slabs through the mapping);
// an importer calls it once every piece, its own and the imported, is
// mapped.
int rb3c_vmm_access(unsigned long long ptr, unsigned long long size, const int* devs, int n) {
  CuApi* d;
  const int s = cu_api(&d);
  if (s) return s;
  CUmemAccessDesc a[16];
  if (n < 1 || n > 16) return (int)CUDA_ERROR_INVALID_VALUE;
  for (int i = 0; i < n; ++i) {
    a[i] = {};
    a[i].location.type = CU_MEM_LOCATION_TYPE_DEVICE;
    a[i].location.id = devs[i];
    a[i].flags = CU_MEM_ACCESS_FLAGS_PROT_READWRITE;
  }
  return (int)d->set_access(ptr, size, a, n);
}

// Wait for cards devs[0:n) (nothing may still read the range), unmap the
// `mapped` bytes from ptr and free the reserved `size`.  The current
// device is restored.
int rb3c_vmm_free(unsigned long long ptr, unsigned long long mapped, unsigned long long size, const int* devs, int n) {
  CuApi* d;
  int s = cu_api(&d);
  if (s) return s;
  int cur;
  cudaError_t e = cudaGetDevice(&cur);
  for (int i = 0; i < n && e == cudaSuccess; ++i) {
    e = cudaSetDevice(devs[i]);
    if (e == cudaSuccess) e = cudaDeviceSynchronize();
  }
  if (e == cudaSuccess) e = cudaSetDevice(cur);
  if (e != cudaSuccess) return kRuntime + (int)e;
  if (mapped) s = (int)d->unmap(ptr, mapped);
  const int f = (int)d->address_free(ptr, size);
  return s ? s : f;
}

// The name of a code that an entry point above returned.
const char* rb3c_vmm_error(int code) {
  if (code >= kRuntime) return cudaGetErrorString((cudaError_t)(code - kRuntime));
  CuApi* d;
  const char* str = nullptr;
  if (cu_api(&d) == 0 && d->error_string((CUresult)code, &str) == CUDA_SUCCESS && str) return str;
  return "unknown CUresult";
}

}  // extern "C"
